"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each passes or raises; any failure exits non-zero):
  1. device: require CUDA; print the card's name and power limit (nvidia-smi);
  2. build: compile every kernel of the path from the checkout's sources;
  3. kernels: hold each entry point of the stat-scores kernel bitwise against
     its plain PyTorch version at the main path's shapes and at edge shapes:
     the canonical route on int32 and bool one-hots, the logits route on
     float32, bfloat16 and float16 logits with int64 and int32 labels,
     including NaN, tied, signed-zero and infinite logits and labels out of
     range;
  4. main path: an ImageNet-1k validation pass (50,000 samples, 1000 classes,
     batches of 1024) through configuration 1 (``Accuracy`` with ``forward``
     per batch), configuration 2 (``Accuracy``/``F1Score``/``Precision``
     macro and ``ConfusionMatrix`` in a ``MetricCollection``) and the top-5
     accuracy such a pass reports beside top-1, each checked against an
     independent numpy float64 computation, with each entry point's launches
     counted over each run and checked against what the routes and compute
     groups imply;
  5. timings: samples/s per configuration, and each entry point's device
     time beside its plain version and its bound; the logits route also
     beside the chain of operations it replaces.
The last line is ``{"ok": true, "device": {...}}``.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

N_SAMPLES, N_CLASSES, BATCH = 50_000, 1000, 1024
SEED = 0
DEVICE = "cuda"  # where the data lives and the metrics keep their state
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
INT32_OPS_PER_S = 67e12  # the 32-bit non-tensor-core rate from the same sheet
KERNEL_SHAPES = [(1024, 1000), (848, 1000), (3, 5), (0, 4), (4096, 4097)]
LOGIT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
NAN_BITS = {torch.bfloat16: (0x7FC0, -0x40), torch.float16: (0x7E00, -0x200)}  # (+NaN, -NaN) as int16
TOP_K = 5
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


def _compare(name: str, got, expected, case: str) -> int:
    """Four counts against their plain version, bitwise; returns the largest abs error (0)."""
    worst = 0
    for which, g, e in zip(("tp", "fp", "tn", "fn"), got, expected):
        if g.dtype != torch.int32 or not torch.equal(g, e):
            raise AssertionError(f"{name} kernel disagrees with its plain version: {which} at {case}")
        worst = max(worst, int((g.long() - e.long()).abs().max()) if g.numel() else 0)
    print(f"kernel {name} {case}: bitwise equal to plain")
    return worst


def _logit_cases(n: int, c: int, dtype: torch.dtype, label_dtype: torch.dtype, seed: int):
    """Logits on a grid of eighths in [-2, 2] (ties in most rows), rows of NaN, -NaN,
    signed zeros and infinities, and labels out of range on both sides, on the card."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-16, 17, (n, c)) / 8).astype(np.float32)
    labels = rng.integers(0, c, n)
    special = n >= 8 and c >= 4
    if special:
        x[0] = -np.inf
        x[1, 1::2] = np.nan
        x[2] = 0.0
        x[2, 0] = -0.0
        x[3, 1] = np.copysign(np.nan, -1.0)
        x[4, 2:4] = np.inf
        labels[5:8] = (c, -1, c + 100)
    logits = torch.from_numpy(x).to(device=DEVICE, dtype=dtype)
    if dtype in NAN_BITS and special:  # the conversion may not keep a NaN's sign
        bits = logits.view(torch.int16)
        bits[1, 1::2], bits[3, 1] = NAN_BITS[dtype]
    return logits, torch.from_numpy(labels).to(device=DEVICE, dtype=label_dtype)


def phase_kernels(ops) -> Tuple[int, int]:
    """Each entry point vs its plain version, bitwise, on the card.  Returns the largest abs errors (0, 0)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    worst = 0
    for (n, c), dtype in [(shape, torch.int32) for shape in KERNEL_SHAPES] + [
        (shape, torch.bool) for shape in KERNEL_SHAPES
    ]:
        preds = torch.randint(0, 2, (n, c), generator=gen, device=DEVICE).to(dtype)
        target = torch.randint(0, 2, (n, c), generator=gen, device=DEVICE).to(dtype)
        got = ops.fused_stat_scores(preds, target)
        torch.cuda.synchronize()
        expected = ops.fused_stat_scores_plain(preds, target)
        torch.cuda.synchronize()
        worst = max(worst, _compare("stat_scores", got, expected, f"{(n, c)} {str(dtype).replace('torch.', '')}"))
    values = torch.randint(-1, 3, (2, 300, 40), generator=gen, device=DEVICE, dtype=torch.int32)
    worst = max(worst, _compare("stat_scores", ops.fused_stat_scores(values[0], values[1]),
                                ops.fused_stat_scores_plain(values[0], values[1]), "(300, 40) int32 in [-1, 2]"))

    worst_logits = 0
    for (n, c) in KERNEL_SHAPES + [(16, 1)]:
        for dtype in LOGIT_DTYPES:
            for label_dtype in (torch.int64, torch.int32):
                logits, labels = _logit_cases(n, c, dtype, label_dtype, seed=n + c)
                got = ops.fused_stat_scores_logits(logits, labels)
                torch.cuda.synchronize()
                expected = ops.fused_stat_scores_logits_plain(logits, labels)
                torch.cuda.synchronize()
                case = f"{(n, c)} {str(dtype).replace('torch.', '')} logits, {str(label_dtype).replace('torch.', '')} labels"
                worst_logits = max(worst_logits, _compare("stat_scores_logits", got, expected, case))
    return worst, worst_logits


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
    # top-k by rank: the larger logits, and the equal ones at a lower index (lax.top_k's order of ties)
    scores = logits.cpu().numpy()
    own = scores[np.arange(len(target)), target][:, None]
    rank = (scores > own).sum(axis=1) + ((scores == own) & (np.arange(N_CLASSES) < target[:, None])).sum(axis=1)
    return {
        "cm": cm,
        "micro_acc": tp.sum() / len(target),
        "macro_acc": recall[present].mean(),
        "macro_precision": precision[present].mean(),
        "macro_f1": f1[present].mean(),
        "last_batch_acc": float((pred[-(N_SAMPLES % BATCH):] == target[-(N_SAMPLES % BATCH):]).mean()),
        "top_k_acc": (rank < TOP_K).mean(),
    }


def _check_close(name: str, got: torch.Tensor, expected: float) -> None:
    value, expected = float(got), float(expected)
    if not np.isclose(value, expected, rtol=FLOAT_RTOL, atol=0.0):
        raise AssertionError(f"{name}: port {value!r} vs numpy {expected!r}")
    print(f"check {name}: {value!r} (numpy {expected!r})")


def _route(metric) -> Optional[str]:
    """The stat-scores entry point one update of this metric launches on float logits and
    integer labels: ``logits`` for top-1 macro/micro, ``canonical`` for top-k; None for no kernel."""
    if getattr(metric, "reduce", None) not in ("macro", "micro") or metric.mdmc_reduce == "samplewise":
        return None
    if (metric.top_k or 1) == 1 and metric.ignore_index is None and metric.multiclass is not False:
        return "logits"
    return "canonical"


def _counters(ops) -> dict:
    return {"logits": ops.fused_stat_scores_logits, "canonical": ops.fused_stat_scores}


def _driven(ops, name: str, run, implied):
    """Run one configuration with every launch count set to 0 just before it and read just after;
    the counts must be ``implied()``, what its routes and compute groups imply once it has run.
    Returns (result, seconds, counts)."""
    for fn in _counters(ops).values():
        fn.launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    result = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    counts = {route: fn.launches for route, fn in _counters(ops).items()}
    expected = implied()
    print(f"{name} launches per entry point: {counts} (routes and compute groups imply {expected})")
    if counts != expected or not any(counts.values()):
        raise AssertionError(f"{name} did not launch the stat-scores kernels as its routes and compute groups imply")
    return result, secs, counts


def phase_main_path(mt, ops) -> dict:
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    logits = torch.randn((N_SAMPLES, N_CLASSES), generator=gen, device=DEVICE)
    labels = torch.randint(0, N_CLASSES, (N_SAMPLES,), generator=gen, device=DEVICE)
    # a classifier that is right about a quarter of the time
    logits.scatter_add_(1, labels[:, None], torch.full((N_SAMPLES, 1), 2.5, device=DEVICE))
    batches = [(logits[i : i + BATCH], labels[i : i + BATCH]) for i in range(0, N_SAMPLES, BATCH)]
    n_batches = len(batches)

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

    def top_k_accuracy():
        return mt.Accuracy(num_classes=N_CLASSES, top_k=TOP_K, device=DEVICE)

    # warm-up on two batches: loads the CUDA modules of every op on the path
    warm1, warm2, warm3 = config1(), config2(), top_k_accuracy()
    for preds, target in batches[:2]:
        warm1(preds, target)
        warm2.update(preds, target)
        warm3.update(preds, target)
    warm1.compute(), warm2.compute(), warm3.compute()
    torch.cuda.synchronize()

    def per_batch(metric):
        def implied() -> dict:
            expected = {route: 0 for route in _counters(ops)}
            expected[_route(metric)] += n_batches
            return expected

        return implied

    acc1 = config1()
    (batch_values, top1), secs1, counts1 = _driven(
        ops, "config1", lambda: ([acc1(preds, target) for preds, target in batches], acc1.compute()), per_batch(acc1)
    )

    col = config2()

    def run2():
        for preds, target in batches:
            col.update(preds, target)
        return col.compute()

    def implied2() -> dict:
        print(f"compute groups: {col.compute_groups}")
        expected = {route: 0 for route in _counters(ops)}
        for metric in col.values():  # first batch: every member updates
            if _route(metric):
                expected[_route(metric)] += 1
        for group in col.compute_groups.values():  # then one update per group, by its first member
            if _route(col[group[0]]):
                expected[_route(col[group[0]])] += n_batches - 1
        return expected

    out2, secs2, counts2 = _driven(ops, "config2", run2, implied2)

    acc3 = top_k_accuracy()

    def run3():
        for preds, target in batches:
            acc3.update(preds, target)
        return acc3.compute()

    top_k, secs3, counts3 = _driven(ops, f"top-{TOP_K} accuracy", run3, per_batch(acc3))

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
    _check_close(f"top-{TOP_K} accuracy", top_k, ref["top_k_acc"])
    for key, value in out2.items():
        if not torch.isfinite(value.float()).all():
            raise AssertionError(f"{key} is not finite")

    print(f"config1 samples/s: {N_SAMPLES / secs1!r} ({secs1!r} s, forward per batch + compute)")
    print(f"config2 samples/s: {N_SAMPLES / secs2!r} ({secs2!r} s, update per batch + compute)")
    print(f"top-{TOP_K} accuracy samples/s: {N_SAMPLES / secs3!r} ({secs3!r} s, update per batch + compute)")
    totals = {route: counts1[route] + counts2[route] + counts3[route] for route in _counters(ops)}
    print(f"main path launches per entry point: {totals}")
    return totals


def _device_ops(fn, calls: int = 1) -> Optional[list]:
    """(name, device ms) of each device operation that ``calls`` calls of ``fn`` issue, as
    torch.profiler records them; None where the profiler records no device activity on this machine."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as err:
        print(f"profiler: {err}")
        return None
    seen = [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return seen or None


def _in_turns(fns: dict, order: list) -> dict:
    """Each function's device time per call, measured in the given order (A, B, B, A: the card's
    drift falls on both alike); the mean of its turns' medians."""
    turns = {name: [] for name in fns}
    for name in order:
        turns[name].append(_device_ms(fns[name])[0])
    for name, values in turns.items():
        print(f"  {name}: {values!r} ms")
    return {name: statistics.mean(values) for name, values in turns.items()}


def _bound(bytes_moved: int, operations: int) -> Tuple[float, str]:
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = operations / INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _one_launch(name: str, fn, calls: int = 20) -> Optional[float]:
    """Check that each call of ``fn`` issues one device operation; return that operation's own
    median device ms (the profiler's, without the event method's per-call cost)."""
    seen = _device_ops(fn, calls)
    if seen is None:
        print(f"{name}: device operations per call not checked (the profiler recorded no device activity)")
        return None
    print(f"{name}: {len(seen)} device operations in {calls} calls: {sorted({op for op, _ in seen})}")
    if len(seen) != calls:
        raise AssertionError(f"{name} issued {len(seen)} device operations in {calls} calls, not one a call")
    return statistics.median(ms for _, ms in seen)


def phase_timings(ops, launches: dict, max_abs_err: Tuple[int, int]) -> list:
    from metrics_tpu_torch.utils.data import select_topk, to_onehot

    n, c = BATCH, N_CLASSES
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    preds = torch.randint(0, 2, (n, c), generator=gen, device=DEVICE, dtype=torch.int32)
    target = torch.randint(0, 2, (n, c), generator=gen, device=DEVICE, dtype=torch.int32)
    kernel = lambda: ops.fused_stat_scores(preds, target)  # noqa: E731
    plain = lambda: ops.fused_stat_scores_plain(preds, target)  # noqa: E731
    empty_ms = _device_ms(lambda: torch.cuda._sleep(0))[0]
    print(f"an empty kernel (torch.cuda._sleep(0)) by the same method: {empty_ms!r} ms per call")
    kernel_own_ms = _one_launch("stat_scores", kernel)
    print(f"stat_scores at {(n, c)} int32, device ms per call (inputs warm in L2), in turns:")
    times = _in_turns({"plain": plain, "kernel": kernel}, ["plain", "kernel", "kernel", "plain"])
    kernel_call_ms, plain_call_ms = _call_ms(kernel), _call_ms(plain)
    # each input read once, four (C,) int32 out; two compares and four masked adds per element
    bound_ms, bound_by = _bound(2 * n * c * preds.element_size() + 4 * c * 4, 6 * n * c)
    print(f"stat_scores at {(n, c)} int32: kernel {times['kernel']!r} ms (its own device time {kernel_own_ms!r} ms), "
          f"plain {times['plain']!r} ms, bound {bound_ms!r} ms ({bound_by}); one call on an idle card, host launch work included: "
          f"kernel {kernel_call_ms!r} ms, plain {plain_call_ms!r} ms")
    flags = preds.bool(), target.bool()
    bool_ms = _device_ms(lambda: ops.fused_stat_scores(*flags))[0]
    bool_own_ms = _one_launch("stat_scores bool", lambda: ops.fused_stat_scores(*flags))
    bool_bound, _ = _bound(2 * n * c + 4 * c * 4, 6 * n * c)
    print(f"stat_scores at {(n, c)} bool: kernel {bool_ms!r} ms (its own device time {bool_own_ms!r} ms), "
          f"bound {bool_bound!r} ms")
    canonical = {
        "name": "stat_scores",
        "route": "cuda",
        "source": "metrics_tpu_torch/ops/csrc/stat_scores.cu",
        "replaces": "metrics_tpu/ops/stat_scores_pallas.py:124",
        "launches": launches["canonical"],
        "bitwise": max_abs_err[0] == 0,
        "max_abs_err": max_abs_err[0],
        "ms": times["kernel"],
        "kernel_ms": kernel_own_ms,
        "empty_kernel_ms": empty_ms,
        "plain_ms": times["plain"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "library_note": "no single PyTorch call computes the four counts",
    }

    for dtype in LOGIT_DTYPES:
        logits = torch.randn((n, c), generator=gen, device=DEVICE).to(dtype)
        labels = torch.randint(0, c, (n,), generator=gen, device=DEVICE)
        kernel = lambda: ops.fused_stat_scores_logits(logits, labels)  # noqa: E731
        name = str(dtype).replace("torch.", "")
        # each input read once, four (C,) int32 out; about six integer operations per logit (its order key and the max)
        bound_ms, bound_by = _bound(n * c * logits.element_size() + n * labels.element_size() + 4 * c * 4, 6 * n * c)
        if dtype != torch.float32:
            own_ms = _one_launch(f"stat_scores_logits {name}", kernel)
            print(f"stat_scores_logits at {(n, c)} {name} logits, int64 labels: kernel {_device_ms(kernel)[0]!r} ms "
                  f"(its own device time {own_ms!r} ms), bound {bound_ms!r} ms")
            continue
        plain = lambda: ops.fused_stat_scores_logits_plain(logits, labels)  # noqa: E731
        chain = lambda: ops.fused_stat_scores(select_topk(logits, 1), to_onehot(labels, c))  # noqa: E731
        kernel_own_ms = _one_launch("stat_scores_logits", kernel)
        chain_ops = _device_ops(chain) or []
        print(f"the chain the logits route replaces: {len(chain_ops)} device operations per call "
              f"(0: not counted), {sum(ms for _, ms in chain_ops)!r} ms of their own device time: "
              f"{[op.split('<')[0].split('(')[0][-48:] for op, _ in chain_ops]}")
        print(f"stat_scores_logits at {(n, c)} float32 logits, int64 labels, device ms per call, in turns:")
        times = _in_turns({"plain": plain, "kernel": kernel, "chain": chain},
                          ["plain", "kernel", "chain", "chain", "kernel", "plain"])
        kernel_call_ms, chain_call_ms = _call_ms(kernel), _call_ms(chain)
        print(f"stat_scores_logits at {(n, c)} float32: kernel {times['kernel']!r} ms (its own device time "
              f"{kernel_own_ms!r} ms), plain {times['plain']!r} ms, "
              f"chain (select_topk, to_onehot, stat_scores kernel) {times['chain']!r} ms, bound {bound_ms!r} ms "
              f"({bound_by}); one call on an idle card, host launch work included: kernel {kernel_call_ms!r} ms, "
              f"chain {chain_call_ms!r} ms")
        logits_entry = {
            "name": "stat_scores_logits",
            "route": "cuda",
            "source": "metrics_tpu_torch/ops/csrc/stat_scores.cu",
            "replaces": "metrics_tpu/ops/stat_scores_pallas.py:124",
            "launches": launches["logits"],
            "bitwise": max_abs_err[1] == 0,
            "max_abs_err": max_abs_err[1],
            "ms": times["kernel"],
            "kernel_ms": kernel_own_ms,
            "empty_kernel_ms": empty_ms,
            "plain_ms": times["plain"],
            "chain_ms": times["chain"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "library_note": "no single PyTorch call computes the four counts from logits and labels",
        }
    return [canonical, logits_entry]


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
    kernels = phase_timings(ops, launches, max_abs_err)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
