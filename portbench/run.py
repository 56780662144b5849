"""Run one cell of ``BENCHMARK.json`` once on the card and print its result as one JSON line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the line holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
(a profiler over the window).  Exits non-zero, printing no result, without CUDA or with fewer cards than
the cell asks for, and when ``jax``, ``jaxlib``, ``flax`` or ``metrics_tpu`` is loaded once the window
has closed.
"""

import time

T0 = time.perf_counter()  # set-up counts from here: the imports below are part of it

import os  # noqa: E402
import sys  # noqa: E402

import argparse  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "metrics_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of :data:`FORBIDDEN`, whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # build and kernel caches at fixed paths inside the checkout (the port's nvcc builds go to build/kernels)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "portbench", ".cache", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "portbench", ".cache", "triton")
    from portbench.cell import Cell
    from portbench.harness import emit, run

    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), found {found}; no result",
              file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad} once the window had closed; no result", file=sys.stderr)
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT  # run by path, the script's own folder heads sys.path: the checkout's root takes its place
    sys.exit(main())
