"""Where a fleet worker's start-up goes: the stages of ``python -m metrics_tpu_torch.serve.worker`` up to ``READY``.

Run from the root of a checkout (on the card, or ``--device cpu``):

    python3 tools/worker_start_probe.py [--device cuda] [--together 2]

A child interpreter walks the worker's start-up one stage at a time and
stamps each: the interpreter itself, ``import torch``, the device's first
tensor (a CUDA context on the card), ``import metrics_tpu_torch``, the worker
module, ``run_worker`` (the registry and a started ``EvalServer``).  It runs
one child alone, then ``--together`` children at once (as phase 18 of
``chip_smoke.py`` starts its workers), then the real worker module to its
``READY`` line, and last one child under ``-X importtime`` for the slowest
imports of the package.  It prints one JSON line of seconds per stage.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import json, sys, time
device = sys.argv[1]
t = {"interpreter": time.time()}
import torch
t["import_torch"] = time.time()
x = torch.zeros(1, device=device)
if device == "cuda":
    torch.cuda.synchronize()
t["first_tensor"] = time.time()
import metrics_tpu_torch
t["import_metrics_tpu_torch"] = time.time()
from metrics_tpu_torch.serve.worker import run_worker
t["import_worker"] = time.time()
server = run_worker(0, 1, device=device)
t["run_worker"] = time.time()
server.stop(final_checkpoint=False)
print(json.dumps(t), flush=True)
"""


def _stages(t0: float, stamps: dict) -> dict:
    """Seconds each stage took, the first from the parent's start of the process."""
    out, prev = {}, t0
    for name, at in stamps.items():
        out[name] = at - prev
        prev = at
    out["total"] = prev - t0
    return out


def _children(device: str, count: int) -> list:
    procs = []
    for _ in range(count):
        t0 = time.time()
        procs.append((t0, subprocess.Popen([sys.executable, "-c", CHILD, device], cwd=ROOT, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True)))
    out = []
    for t0, proc in procs:
        stdout, stderr = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"probe child failed: {stderr[-2000:]}")
        out.append(_stages(t0, json.loads(stdout.strip().splitlines()[-1])))
    return out


def _ready_s(device: str) -> float:
    """Seconds from starting the real worker module to its READY line."""
    t0 = time.time()
    proc = subprocess.Popen([sys.executable, "-m", "metrics_tpu_torch.serve.worker", "--shard", "0", "--num-shards", "1",
                             "--device", device], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline().strip()
        ready = time.time() - t0
        if not line.startswith("READY "):
            raise RuntimeError(f"worker printed {line!r}: {proc.stderr.read()[-2000:]}")
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    return ready


def _slowest_imports(top: int = 12) -> dict:
    """The slowest imports of the worker module under ``-X importtime``, by own and by cumulative seconds."""
    proc = subprocess.run([sys.executable, "-X", "importtime", "-c", "import metrics_tpu_torch.serve.worker"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    rows = []
    for line in proc.stderr.splitlines():
        if not line.startswith("import time:") or "self [us]" in line:
            continue
        own, cumulative, name = line.split(":", 1)[1].split("|")
        rows.append((int(own) / 1e6, int(cumulative) / 1e6, name.strip()))
    by_own = [{"module": n, "own_s": o, "cumulative_s": c} for o, c, n in sorted(rows, reverse=True)[:top]]
    by_cumulative = [{"module": n, "cumulative_s": c} for c, _o, n in sorted(((c, o, n.strip()) for o, c, n in rows),
                                                                             reverse=True)[:top]]
    return {"by_own_time": by_own, "by_cumulative_time": by_cumulative}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--together", type=int, default=2)
    args = parser.parse_args()
    card = None
    if args.device == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
        print(card)
    result = {"card": card, "device": args.device, "alone": _children(args.device, 1)[0],
              "together": _children(args.device, args.together), "worker_ready_s": _ready_s(args.device),
              "slowest_imports": _slowest_imports()}
    print(json.dumps({"worker_start": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
