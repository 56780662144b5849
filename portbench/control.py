"""Readings for the limits of ``correct``: the program's, the control's and the planted faults', for many
seeds in one process.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...] --seconds <s>
        [--no-program] [--control-seeds <k>] [--faults <fault> ...]

For each seed it prints one JSON line: the numbers the cell compares as a short window of the program
produces them (``program``: the task's own run, its inputs and window), as the control produces them
(``control``: the plain reference one step below the configuration's precision, in the program's place,
over one whole pass of the same inputs), and as a short window of the program produces them with each
named fault of ``portbench/faults.py`` planted (``faults``).  A limit lies above the program's readings
and below the control's; each fault has to come out not correct.  The benchmark's own runs never run any
of this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--no-program", action="store_true")
    parser.add_argument("--control-seeds", type=int, default=None, help="run the control on the first N seeds only")
    parser.add_argument("--faults", nargs="*", default=[], help="faults to plant, each in its own window")
    args = parser.parse_args(argv)
    from portbench.cell import Cell
    from portbench.faults import Patch, faults_of
    from portbench.harness import within
    from portbench.tracing import Tracer

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = Cell(args.workload)
    task, limits = cell.task(), cell.limits()
    faults = faults_of(cell)

    def window(seed: int):
        out = task.run(cell, seed=seed, seconds=args.seconds, tracer=Tracer(False), device="cuda",
                       t0=time.perf_counter(), limits=limits)
        correct = out.failed == 0 and all(within(v, limits.get(k)) for k, v in out.checks)
        return {"checks": dict(out.checks), "answers": out.attempted, "failed": out.failed, "correct": correct}

    for index, seed in enumerate(args.seeds):
        line = {"workload": args.workload, "seed": seed}
        if not args.no_program:
            got = window(seed)
            line["program"], line["answers"] = got["checks"], got["answers"]
        if args.control_seeds is None or index < args.control_seeds:
            checks, _, _ = task.control(cell, seed, "cuda", limits)
            line["control"] = dict(checks)
        for name in args.faults:
            patch = Patch()
            faults[name](patch)
            try:
                line.setdefault("faults", {})[name] = window(seed)
            except Exception as exc:  # a fault that crashes the run gives no result: not correct
                line.setdefault("faults", {})[name] = {"raised": f"{type(exc).__name__}: {exc}"[:300],
                                                       "correct": False}
            finally:
                patch.undo()
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())
