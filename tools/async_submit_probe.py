"""Where the first ``sync_async()`` of a process spends its time, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 tools/async_submit_probe.py

Each variant runs in a process of its own, so each first submit is a cold
one.  A variant builds the collection of ``chip_smoke.py`` phase 13 (b)
(macro accuracy, F1 and precision, a confusion matrix and AUROC over 1,000
classes; 25 batches of 1,024 softmax rows), syncing through
``ChaosBackend(LoopbackBackend(), packed=True, stall_secs=0.25)`` (a world
of one whose every collective sleeps, as the stalled peer does there), and
times each member's first submit and, after that round has ended and one more
batch, its second:

* ``cold``: nothing warmed but what building the metrics does (their side
  stream, made when a metric takes a CUDA device);
* ``profiled``: as ``cold``, the first submit under ``cProfile`` (the
  caller's thread only), whose heaviest functions are printed;
* ``side_stream``: the side stream and a CUDA event made first;
* ``worker``: the worker thread started first, by an empty round;
* ``worker_cuda``: the worker started by a round that runs one kernel on the
  side stream, as a sync round's device work does.

It prints the card's name and power limit, a line per variant and, last, one
JSON object with every variant's times, the collection's construction
(``construct_ms``) among them.
"""

import cProfile
import io
import json
import pstats
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = ("cold", "profiled", "side_stream", "worker", "worker_cuda")
N_CLASSES, BATCH, BATCHES = 1000, 1024, 25
STALL_SECS = 0.25


def _collection(mt, backend):
    kw = {"device": "cuda", "sync_backend": backend}
    return mt.MetricCollection(
        {
            "acc": mt.Accuracy(num_classes=N_CLASSES, average="macro", **kw),
            "f1": mt.F1Score(num_classes=N_CLASSES, average="macro", **kw),
            "prec": mt.Precision(num_classes=N_CLASSES, average="macro", **kw),
            "cm": mt.ConfusionMatrix(num_classes=N_CLASSES, **kw),
            "auroc": mt.AUROC(num_classes=N_CLASSES, **kw),
        },
        device="cuda",
    )


def _timed_submit(col) -> tuple:
    """Each member's ms in one ``col.sync_async()`` (the collection submits its group leaders), and the total."""
    times = {}
    for name, metric in col.items():
        submit = metric.__class__.sync_async

        def timed(*args, _metric=metric, _name=name, _submit=submit, **kwargs):
            start = time.perf_counter()
            handle = _submit(_metric, *args, **kwargs)
            times[_name] = (time.perf_counter() - start) * 1e3
            return handle

        metric.sync_async = timed
    start = time.perf_counter()
    handles = col.sync_async()
    times["total"] = (time.perf_counter() - start) * 1e3
    return times, handles


def run_variant(variant: str) -> dict:
    sys.path.insert(0, str(ROOT))
    import metrics_tpu_torch as mt
    from metrics_tpu_torch.metric import _side_stream
    from metrics_tpu_torch.parallel import ChaosBackend, LoopbackBackend, submit_async_round

    gen = torch.Generator(device="cuda").manual_seed(0)
    batches = [(torch.softmax(torch.randn((BATCH, N_CLASSES), generator=gen, device="cuda"), 1),
                torch.randint(0, N_CLASSES, (BATCH,), generator=gen, device="cuda")) for _ in range(BATCHES + 1)]
    start = time.perf_counter()
    col = _collection(mt, ChaosBackend(LoopbackBackend(), packed=True, stall_secs=STALL_SECS))
    construct_ms = (time.perf_counter() - start) * 1e3
    for probs, target in batches[:BATCHES]:
        col.update(probs, target)
    torch.cuda.synchronize()
    device = torch.device("cuda", torch.cuda.current_device())
    if variant == "side_stream":
        _side_stream(device)
        torch.cuda.Event().record(torch.cuda.current_stream(device))
    elif variant == "worker":
        submit_async_round(lambda: None, label="warm").result()
    elif variant == "worker_cuda":
        stream = _side_stream(device)

        def kernel_on_side_stream():
            with torch.cuda.device(device), torch.cuda.stream(stream):
                torch.zeros(1, device=device).add_(1)
                stream.synchronize()

        submit_async_round(kernel_on_side_stream, label="warm").result()
    profile = None
    if variant == "profiled":
        profile = cProfile.Profile()
        profile.enable()
    first, handles = _timed_submit(col)
    if profile is not None:
        profile.disable()
    for handle in handles.values():
        handle.result()
    col.update(*batches[BATCHES])
    torch.cuda.synchronize()
    second, handles = _timed_submit(col)
    for handle in handles.values():
        handle.result()
    out = {"construct_ms": construct_ms, "first_ms": first, "second_ms": second}
    if profile is not None:
        text = io.StringIO()
        pstats.Stats(profile, stream=text).sort_stats("cumulative").print_stats(25)
        out["profile"] = text.getvalue()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("async_submit_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()
    print(card)
    results = {"card": card}
    for variant in VARIANTS:
        proc = subprocess.run([sys.executable, __file__, "--variant", variant], cwd=ROOT,
                              capture_output=True, text=True, check=False, timeout=300)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        seen = json.loads(proc.stdout.strip().splitlines()[-1])
        if "profile" in seen:
            print(seen.pop("profile"))
        results[variant] = seen
        print(f"{variant}: construction ms {seen['construct_ms']!r}; first submit ms {seen['first_ms']!r}; "
              f"second {seen['second_ms']!r}")
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--variant":
        print(json.dumps(run_variant(sys.argv[2])))
        sys.exit(0)
    sys.exit(main())
