"""The KLL fold kernel's stages, launch by launch, and its key chain alone, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 tools/kll_fold_probe.py

It prints, with the card's name and power limit, for one update of 2,457,600
values (8 NYU-Depth-v2-sized maps: 2,400 chunks at capacity 2048, 19,200 at
the default capacity 256, ``max_items=2**28``) folded into a state three such
updates deep (seeded data):

1. every device operation of one ``kll_fold`` call (the plan, the execution
   of each level, the top level's chain, the assembly) with its own device
   time (``torch.profiler``), and their sum;
2. the same for variants of ``ops/csrc/kll_fold.cu`` built beside it under
   ``build/kll_variants/``: ``chain`` switches the plan's walkers off, so its
   plan stage is the key chain and the coins alone (the floor of any
   bitwise design; its results are not the fold's), and ``step32`` halves
   the plan's pipeline step.  Each variant is checked bitwise against the
   plain version where it should be, and the variants are timed in turns
   (forward, then backward).
"""

import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STEP = "constexpr int kStep = 64;"
WALKERS = "const bool walker = lane == 0 &&"
VALUES = 8 * 480 * 640


def _device_ops(fn, calls: int = 3) -> list:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def main() -> int:
    if not torch.cuda.is_available():
        print("kll_fold_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from metrics_tpu_torch.ops import _build, kll
    from metrics_tpu_torch.streaming import sketches as sk

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    source = kll._SOURCE.read_text()
    assert STEP in source and WALKERS in source, "the probe's switches no longer match kll_fold.cu"
    variants = {
        "kernel": (source, True),
        "chain": (source.replace(WALKERS, "const bool walker = n < 0 && lane == 0 &&"), False),
        "step32": (source.replace(STEP, "constexpr int kStep = 32;"), True),
    }
    out = ROOT / "build" / "kll_variants"
    out.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, (text, _) in variants.items():
        paths[name] = out / f"kll_fold_{name}.cu"
        paths[name].write_text(text)
    _build.build(*paths.values())

    rng = np.random.default_rng(0)
    cases = {}
    for capacity in (2048, 256):
        state = sk.kll_init(capacity, max_items=1 << 28, device="cuda")
        for _ in range(3):
            state = sk.kll_update(state, torch.from_numpy(rng.random(VALUES, np.float32)).cuda())
        values = torch.from_numpy(rng.random(VALUES, np.float32)).cuda()
        sk.kll_fold = kll.kll_fold_plain
        try:
            want = sk.kll_update(state, values)
        finally:
            sk.kll_fold = kll.kll_fold
        cases[capacity] = (state, values, want)

    for order in (list(variants), list(reversed(variants))):
        for name in order:
            kll._SOURCE = paths[name]
            kll._library.cache_clear()
            for capacity, (state, values, want) in cases.items():
                got = sk.kll_update(state, values)
                same = all(got[k].cpu().numpy().tobytes() == want[k].cpu().numpy().tobytes() for k in got)
                if variants[name][1] and not same:
                    raise AssertionError(f"variant {name} at capacity {capacity} differs from the plain version")
                ops = [(op, ms) for op, ms in _device_ops(lambda: sk.kll_update(state, values)) if "kll_fold" in op]
                per_call = len(ops) // 3
                plan = statistics.median(ms for op, ms in ops if "kll_fold_plan" in op)
                print(f"{name:7s} capacity {capacity}: {'bitwise' if same else 'not the fold'}, "
                      f"{sum(ms for _, ms in ops) / 3:.4f} ms a call, plan {plan:.4f} ms; one call's "
                      f"{per_call} operations (us): {[round(ms * 1e3, 1) for _, ms in ops[:per_call]]}")
    kll._SOURCE = _build.CSRC / "kll_fold.cu"
    kll._library.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
