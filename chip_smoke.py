"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each passes or raises; any failure exits non-zero):
  1. device: require CUDA; print the card's name and power limit (nvidia-smi);
  2. build: compile every kernel of the path from the checkout's sources;
  3. kernels: hold each kernel bitwise against its plain PyTorch version at
     the main path's shapes and at edge shapes;
  4. main path: an ImageNet-1k validation pass (50,000 samples, 1000 classes,
     batches of 1024) through configuration 1 (``Accuracy`` with ``forward``
     per batch) and configuration 2 (``Accuracy``/``F1Score``/``Precision``
     macro and ``ConfusionMatrix`` in a ``MetricCollection``), checked
     against an independent numpy float64 computation, with the kernel
     launches counted over this run and checked against what the compute
     groups imply;
  5. timings: samples/s per configuration, and each kernel's time beside its
     plain version and its bound.
The last line is ``{"ok": true, "device": {...}}``.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

N_SAMPLES, N_CLASSES, BATCH = 50_000, 1000, 1024
SEED = 0
DEVICE = "cuda"  # where the data lives and the metrics keep their state
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
INT32_OPS_PER_S = 67e12  # the 32-bit non-tensor-core rate from the same sheet
KERNEL_SHAPES = [(1024, 1000), (848, 1000), (3, 5), (0, 4), (4096, 4097)]
FLOAT_RTOL = 1e-5  # float32 scores from int32 counts vs float64 numpy
SLEEP_CYCLES = 100_000_000  # the spinning kernel timed calls queue behind (about 50 ms)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _device_ms(fn, calls: int = 50, per_sleep: int = 10, warmup: int = 10) -> Tuple[float, float]:
    """Median device time of one call over ``calls`` calls, and the host's
    mean time to issue one call.

    Each group of ``per_sleep`` calls queues behind a spinning kernel, so the
    card runs them back to back with no gaps for the host's launch work, and
    an event after each call times it.  Groups stay small because the launch
    queue holds about a thousand entries: a longer run blocks the host, and
    the card would wait for it again.
    """
    for _ in range(warmup):
        fn()
    times, host_total_ms = [], 0.0
    for _ in range(calls // per_sleep):
        torch.cuda.synchronize()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(per_sleep + 2)]
        host_start = time.perf_counter()
        events[0].record()
        torch.cuda._sleep(SLEEP_CYCLES)
        events[1].record()
        for event in events[2:]:
            fn()
            event.record()
        host_ms = (time.perf_counter() - host_start) * 1e3
        events[-1].synchronize()
        slept_ms = events[0].elapsed_time(events[1])
        if host_ms >= slept_ms:
            raise AssertionError(f"the host took {host_ms} ms to queue {per_sleep} calls behind a {slept_ms} ms sleep")
        times += [a.elapsed_time(b) for a, b in zip(events[1:], events[2:])]
        host_total_ms += host_ms
    return statistics.median(times), host_total_ms / len(times)


def _call_ms(fn, reps: int = 100, warmup: int = 10) -> float:
    """Median time of one call as a caller sees it: CUDA events around each call
    on an idle card, so the host's launch work counts too."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_build(ops) -> None:
    start = time.perf_counter()
    path, log = ops.build()
    ops._library()
    print(f"build: {path.relative_to(ROOT)} in {time.perf_counter() - start:.3f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def phase_kernels(ops) -> int:
    """Kernel vs plain version, bitwise, on the card.  Returns the largest abs error (0)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    cases = [(shape, torch.int32) for shape in KERNEL_SHAPES] + [((1024, 1000), torch.bool)]
    worst = 0
    for (n, c), dtype in cases:
        preds = torch.randint(0, 2, (n, c), generator=gen, device=DEVICE).to(dtype)
        target = torch.randint(0, 2, (n, c), generator=gen, device=DEVICE).to(dtype)
        got = ops.fused_stat_scores(preds, target)
        torch.cuda.synchronize()
        expected = ops.fused_stat_scores_plain(preds, target)
        torch.cuda.synchronize()
        for name, g, e in zip(("tp", "fp", "tn", "fn"), got, expected):
            if g.dtype != torch.int32 or not torch.equal(g, e):
                raise AssertionError(f"stat_scores kernel disagrees with its plain version: {name} at {(n, c)} {dtype}")
            worst = max(worst, int((g.long() - e.long()).abs().max()) if g.numel() else 0)
        print(f"kernel stat_scores {(n, c)} {str(dtype).replace('torch.', '')}: bitwise equal to plain")
    return worst


def _reference(logits: torch.Tensor, labels: torch.Tensor) -> dict:
    """Independent numpy float64 results from the argmax labels, on the host."""
    pred = logits.cpu().numpy().argmax(axis=1)
    target = labels.cpu().numpy()
    cm = np.bincount(target * N_CLASSES + pred, minlength=N_CLASSES**2).reshape(N_CLASSES, N_CLASSES)
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    present = (tp + fp + fn) > 0  # the JAX package drops classes absent from preds and target
    precision = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 0.0)
    recall = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
    f1 = np.where(precision + recall > 0, 2 * precision * recall / np.maximum(precision + recall, 1e-300), 0.0)
    return {
        "cm": cm,
        "micro_acc": tp.sum() / len(target),
        "macro_acc": recall[present].mean(),
        "macro_precision": precision[present].mean(),
        "macro_f1": f1[present].mean(),
        "last_batch_acc": float((pred[-(N_SAMPLES % BATCH):] == target[-(N_SAMPLES % BATCH):]).mean()),
    }


def _check_close(name: str, got: torch.Tensor, expected: float) -> None:
    value, expected = float(got), float(expected)
    if not np.isclose(value, expected, rtol=FLOAT_RTOL, atol=0.0):
        raise AssertionError(f"{name}: port {value!r} vs numpy {expected!r}")
    print(f"check {name}: {value!r} (numpy {expected!r})")


def _uses_kernel(metric) -> bool:
    """Whether one update of this metric launches the stat-scores kernel (macro on 2-D operands)."""
    return getattr(metric, "reduce", None) == "macro" and getattr(metric, "mdmc_reduce", None) != "samplewise"


def phase_main_path(mt, ops):
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    logits = torch.randn((N_SAMPLES, N_CLASSES), generator=gen, device=DEVICE)
    labels = torch.randint(0, N_CLASSES, (N_SAMPLES,), generator=gen, device=DEVICE)
    # a classifier that is right about a quarter of the time
    logits.scatter_add_(1, labels[:, None], torch.full((N_SAMPLES, 1), 2.5, device=DEVICE))
    batches = [(logits[i : i + BATCH], labels[i : i + BATCH]) for i in range(0, N_SAMPLES, BATCH)]

    def config1():
        return mt.Accuracy(num_classes=N_CLASSES, device=DEVICE)

    def config2():
        return mt.MetricCollection(
            {
                "acc": mt.Accuracy(num_classes=N_CLASSES, average="macro", device=DEVICE),
                "f1": mt.F1Score(num_classes=N_CLASSES, average="macro", device=DEVICE),
                "prec": mt.Precision(num_classes=N_CLASSES, average="macro", device=DEVICE),
                "cm": mt.ConfusionMatrix(num_classes=N_CLASSES, device=DEVICE),
            },
            device=DEVICE,
        )

    # warm-up on two batches: loads the CUDA modules of every op on the path
    warm1, warm2 = config1(), config2()
    for preds, target in batches[:2]:
        warm1(preds, target)
        warm2.update(preds, target)
    warm1.compute(), warm2.compute()
    torch.cuda.synchronize()

    ops.fused_stat_scores.launches = 0
    acc1 = config1()
    torch.cuda.synchronize()
    start = time.perf_counter()
    batch_values = [acc1(preds, target) for preds, target in batches]
    top1 = acc1.compute()
    torch.cuda.synchronize()
    secs1 = time.perf_counter() - start

    col = config2()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for preds, target in batches:
        col.update(preds, target)
    out2 = col.compute()
    torch.cuda.synchronize()
    secs2 = time.perf_counter() - start
    launches = ops.fused_stat_scores.launches

    n_batches = len(batches)
    leaders = [col[group[0]] for group in col.compute_groups.values()]
    expected_launches = (
        n_batches * _uses_kernel(acc1)
        + sum(_uses_kernel(m) for m in col.values())  # first batch: every member updates
        + (n_batches - 1) * sum(_uses_kernel(m) for m in leaders)  # then one update per group
    )
    print(f"compute groups: {col.compute_groups}")
    print(f"stat_scores launches on the main path: {launches} (compute groups imply {expected_launches})")
    if launches != expected_launches or launches == 0:
        raise AssertionError("the main path did not launch the stat-scores kernel as its compute groups imply")

    ref = _reference(logits, labels)
    cm = out2["cm"].cpu().numpy()
    if cm.dtype != np.int32 or not np.array_equal(cm, ref["cm"]):
        raise AssertionError("confusion matrix differs from numpy's bincount")
    print("check cm: bitwise equal to numpy bincount")
    _check_close("config1 accuracy", top1, ref["micro_acc"])
    _check_close("config1 last batch accuracy", batch_values[-1], ref["last_batch_acc"])
    _check_close("config2 macro accuracy", out2["acc"], ref["macro_acc"])
    _check_close("config2 macro precision", out2["prec"], ref["macro_precision"])
    _check_close("config2 macro f1", out2["f1"], ref["macro_f1"])
    for key, value in out2.items():
        if not torch.isfinite(value.float()).all():
            raise AssertionError(f"{key} is not finite")

    print(f"config1 samples/s: {N_SAMPLES / secs1!r} ({secs1!r} s, forward per batch + compute)")
    print(f"config2 samples/s: {N_SAMPLES / secs2!r} ({secs2!r} s, update per batch + compute)")
    return launches


def phase_timings(ops, launches: int, max_abs_err: int) -> dict:
    n, c = BATCH, N_CLASSES
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    preds = torch.randint(0, 2, (n, c), generator=gen, device=DEVICE, dtype=torch.int32)
    target = torch.randint(0, 2, (n, c), generator=gen, device=DEVICE, dtype=torch.int32)
    kernel = lambda: ops.fused_stat_scores(preds, target)  # noqa: E731
    plain = lambda: ops.fused_stat_scores_plain(preds, target)  # noqa: E731
    (kernel_ms, kernel_host_ms), (plain_ms, plain_host_ms) = _device_ms(kernel), _device_ms(plain)
    zeroing_ms, _ = _device_ms(lambda: torch.zeros((4, c), dtype=torch.int32, device=DEVICE))
    kernel_call_ms, plain_call_ms = _call_ms(kernel), _call_ms(plain)
    bytes_moved = 2 * n * c * preds.element_size() + 4 * c * 4  # each input read once, four (C,) int32 out
    operations = 6 * n * c  # two compares, four masked adds per element
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = operations / INT32_OPS_PER_S * 1e3
    print(
        f"stat_scores at {(n, c)} int32, device time per call (inputs warm in L2): kernel {kernel_ms!r} ms "
        f"(of which zeroing the outputs {zeroing_ms!r} ms), plain {plain_ms!r} ms; "
        f"bound {max(bytes_ms, ops_ms)!r} ms (bytes {bytes_ms!r} ms, operations {ops_ms!r} ms)"
    )
    print(
        f"stat_scores at {(n, c)} int32, one call on an idle card, host launch work included: "
        f"kernel {kernel_call_ms!r} ms, plain {plain_call_ms!r} ms; "
        f"host time to issue one call: kernel {kernel_host_ms!r} ms, plain {plain_host_ms!r} ms"
    )
    return {
        "name": "stat_scores",
        "route": "cuda",
        "source": "metrics_tpu_torch/ops/csrc/stat_scores.cu",
        "replaces": "metrics_tpu/ops/stat_scores_pallas.py:124",
        "launches": launches,
        "bitwise": max_abs_err == 0,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes the four counts
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not (ROOT / "metrics_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no metrics_tpu_torch package beside {Path(__file__).name}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import metrics_tpu_torch as mt
    from metrics_tpu_torch.ops import stat_scores as ops

    card = _card_line()
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(card)
    phase_build(ops)
    max_abs_err = phase_kernels(ops)
    launches = phase_main_path(mt, ops)
    kernel = phase_timings(ops, launches, max_abs_err)
    print(json.dumps({"kernels": [kernel]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
