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
  5. sync: the same pass split unevenly over two ranks that share ``cuda:0``
     and sync over ``torch.distributed`` (gloo, a ``FileStore`` in a temporary
     directory): configuration 2 with a ``CatMetric`` of each sample's top
     logit and a ``MeanMetric`` and ``MaxMetric`` of the batch accuracy.
     Both ranks' results must equal phase 4's single-process pass (integers
     bitwise) and numpy's, hold all 50,000 rows in rank order, sit on the
     card and leave each rank's local state in place; a desynced peer must
     raise ``SyncDesyncError`` on both ranks and a stalled one
     ``SyncTimeoutError`` on the live rank within its budget.  A JSON line
     gives the median ms of a synced config-2 ``compute()``, the bytes it
     gathers and each rank's kernel launches;
  6. timings: samples/s per configuration, and each entry point's device
     time beside its plain version and its bound; the logits route also
     beside the chain of operations it replaces;
  7. curves: the same pass, as float32 softmax probabilities, through one
     ``MetricCollection`` of ``AUROC`` and ``AveragePrecision`` (macro, one
     compute group sharing one pair of buffer states), ``Specificity`` and
     ``Dice`` (macro, one stat-scores group on the logits entry point),
     ``HammingDistance`` and ``BinnedAveragePrecision`` (100 thresholds),
     checked against independent numpy/scipy float64 computations (rank-sum
     AUROC, an AP sweep, binned counts, a bincount confusion matrix), with
     the launches and buffer appends checked against the groups; the card's
     exact curves (``roc``, ``precision_recall_curve``, ``auroc`` with
     ``max_fpr``) bitwise against the plain CPU path on tied, signed-zero and
     NaN scores; and the collection synced over two gloo ranks on ``cuda:0``
     (the 25/24 split of phase 5) equal to the single-process pass bitwise;
     its samples/s, compute and update times and peak memory;
  8. rest of classification: the same pass's probabilities through one
     ``MetricCollection`` of ``ConfusionMatrix``, ``JaccardIndex``,
     ``MatthewsCorrCoef``, ``CohenKappa`` (one compute group sharing one
     confusion matrix) and ``CalibrationError`` (15 bins); its logits through
     ``HingeLoss`` (Crammer-Singer, and one-vs-all squared) and, against a
     second seeded classifier's, ``KLDivergence`` (mean, and per row on
     log-probabilities); a multilabel pass of the shape of MS-COCO 2014 val
     (40,504 x 80) through ``CoverageError``, ``LabelRankingAveragePrecision``
     and ``LabelRankingLoss``, without and with sample weights; each against
     an independent numpy/scipy float64 computation (integer counts bitwise);
     the card's ranking, calibration and hinge functionals against the plain
     CPU path on tied, signed-zero, NaN and infinite inputs; update and
     compute times; neither stat-scores entry point may launch.
The last line is ``{"ok": true, "device": {...}}``.

The sync phases run this script again as their ranks
(``chip_smoke.py --sync-rank SCENARIO RANK DIR``); the parent waits on them
with a time limit and fails if a rank fails or hangs.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
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
PROFILER_ATTEMPTS = 3  # torch.profiler sessions at times drop device events: fewer than launched means profile again
SLEEP_CYCLES = 100_000_000  # the spinning kernel timed calls queue behind (about 50 ms)
SYNC_WORLD = 2
SYNC_SHARDS = ((0, 25), (25, 49))  # batch ranges: rank 1 ends with the ragged batch of 848
SYNC_TIMEOUT = 2.0  # the stalled scenario's sync_timeout, seconds
SYNC_SLACK = 3.0  # seconds past timeout x (retries + 1) the live rank may take to raise
SYNC_COMPUTES = 10  # timed synced config-2 computes
SYNC_LIMIT = 300.0  # seconds the parent waits for one two-rank run
CURVE_THRESHOLDS = 100  # BinnedAveragePrecision's thresholds
CURVE_COMPUTES = 3  # timed computes of each curve metric (median)
# per-class AUROC and AP are float32 areas over up to 50,001 float32 curve points, summed in
# a tree: their macro means agree with float64 to about log2(50,001) x 6e-8 ~ 1e-6 relative
CURVE_RTOL = 1e-5
# a binned AP is -sum over 100 steps of (recall difference) x precision, all float32 from
# float32 counts: each step carries about 2 ulp of recall, so <= 101 x 2 x 6e-8 ~ 1.2e-5 absolute
BINNED_ATOL = 2e-5
# Hamming is float32 1 - correct / total: a quotient near 1 keeps up to an ulp of 1.0 of rounding
# (the count above 2**24 and the division), and the subtraction keeps it as an absolute error
HAMMING_ATOL = 2 * 2.0**-23
N_COCO, N_LABELS, COCO_LABELS_MEAN = 40_504, 80, 2.9  # MS-COCO 2014 val: images, labels, labels per image
CE_BINS = 15  # CalibrationError's bins
# MCC's float32 terms c * s, s**2 and the sums near s**2 each carry up to s**2 * 2**-24 of rounding,
# and the numerator cancels: the error is a few such units over sqrt(denominator)
MCC_ATOL_UNITS = 4
# kappa is 1 - k, k a quotient of two float32 sums of C**2 = 10**6 terms, which the card adds in short
# serial runs under a reduction tree: each sum carries a few dozen roundings of 2**-24 of itself at most
KAPPA_ATOL_UNITS = 128
# ECE sums 15 bins of |accuracy - confidence| x proportion, each gap a difference of float32 quotients
# carrying up to 2 ulp of either: a few 2**-24 absolute in all
ECE_ATOL = 8 * 2.0**-24
# a KL row is a float32 sum of 1000 terms of either sign: its error scales with the terms' magnitudes
KL_RTOL = 1e-5


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


def _implied_config2(ops, col, n_batches: int) -> dict:
    """The launches per entry point that ``n_batches`` config-2 updates imply: every member
    on the first batch, then one update per compute group, by its first member."""
    print(f"compute groups: {col.compute_groups}")
    expected = {route: 0 for route in _counters(ops)}
    for metric in col.values():
        if _route(metric):
            expected[_route(metric)] += 1
    for group in col.compute_groups.values():
        if _route(col[group[0]]):
            expected[_route(col[group[0]])] += n_batches - 1
    return expected


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


def _imagenet_pass():
    """The ImageNet-val pass on the card, from seed 0: float32 logits, int64 labels, batches of 1024."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    logits = torch.randn((N_SAMPLES, N_CLASSES), generator=gen, device=DEVICE)
    labels = torch.randint(0, N_CLASSES, (N_SAMPLES,), generator=gen, device=DEVICE)
    # a classifier that is right about a quarter of the time
    logits.scatter_add_(1, labels[:, None], torch.full((N_SAMPLES, 1), 2.5, device=DEVICE))
    batches = [(logits[i : i + BATCH], labels[i : i + BATCH]) for i in range(0, N_SAMPLES, BATCH)]
    return logits, labels, batches


def _config2(mt, **kwargs):
    return mt.MetricCollection(
        {
            "acc": mt.Accuracy(num_classes=N_CLASSES, average="macro", device=DEVICE),
            "f1": mt.F1Score(num_classes=N_CLASSES, average="macro", device=DEVICE),
            "prec": mt.Precision(num_classes=N_CLASSES, average="macro", device=DEVICE),
            "cm": mt.ConfusionMatrix(num_classes=N_CLASSES, device=DEVICE),
        },
        device=DEVICE,
        **kwargs,
    )


COUNTS = ("tp", "fp", "tn", "fn")


def _integer_results(col) -> dict:
    """Config 2's integer results on the host: the confusion matrix and the counts behind each score."""
    out = {"cm": col["cm"].confmat.cpu()}
    for name in ("acc", "f1", "prec"):
        out.update({f"{name}.{k}": getattr(col[name], k).cpu() for k in COUNTS})
    return out


def phase_main_path(mt, ops) -> Tuple[dict, dict, torch.Tensor, torch.Tensor]:
    """Returns each entry point's launches, config 2's integer results, and the pass's logits and labels."""
    logits, labels, batches = _imagenet_pass()
    n_batches = len(batches)

    def config1():
        return mt.Accuracy(num_classes=N_CLASSES, device=DEVICE)

    def config2():
        return _config2(mt)

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

    out2, secs2, counts2 = _driven(ops, "config2", run2, lambda: _implied_config2(ops, col, n_batches))

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
    return totals, _integer_results(col), logits, labels

# ------------------------------------------------------------------ sync
def _rank_main(mt, ops, rank: int, batches, out: Path) -> None:
    """This rank's share of the pass through config 2 and the aggregators, then synced computes."""
    col = _config2(mt)
    cat, mean, top = mt.CatMetric(device=DEVICE), mt.MeanMetric(device=DEVICE), mt.MaxMetric(device=DEVICE)
    first, stop = SYNC_SHARDS[rank]
    for fn in _counters(ops).values():
        fn.launches = 0
    for preds, target in batches[first:stop]:
        col.update(preds, target)
        cat.update(preds.max(dim=1).values)
        acc = (preds.argmax(dim=1) == target).to(torch.float32).mean()
        mean.update(acc, weight=float(target.shape[0]))
        top.update(acc)
    torch.cuda.synchronize()
    launches = {route: fn.launches for route, fn in _counters(ops).items()}
    implied = _implied_config2(ops, col, stop - first)
    members = {**{f"col.{k}": m for k, m in col.items(keep_base=True)}, "cat": cat, "mean": mean, "max": top}
    local = {name: m.state_pytree() for name, m in members.items()}

    results = {f"col.{k}": v for k, v in col.compute().items()}
    aggregate = col.aggregate_sync_report()
    results.update(cat=cat.compute(), mean=mean.compute(), max=top.compute())
    torch.cuda.synchronize()
    devices = sorted({str(v.device) for v in results.values()})
    after = {name: m.state_pytree() for name, m in members.items()}
    unsynced = not any(m._is_synced for m in members.values()) and all(
        local[name].keys() == after[name].keys() and all(
            torch.equal(v, after[name][k]) if isinstance(v, torch.Tensor) else v == after[name][k]
            for k, v in local[name].items()
        )
        for name in members
    )
    synced_counts = {}
    for name in ("acc", "f1", "prec"):  # the counts behind each score, as synced
        with col[name].sync_context():
            synced_counts.update({f"{name}.{k}": getattr(col[name], k).cpu() for k in COUNTS})

    times_ms = []
    for _ in range(SYNC_COMPUTES):
        for m in col.values():
            m._computed = None
        torch.cuda.synchronize()
        start = time.perf_counter()
        col.compute()
        torch.cuda.synchronize()
        times_ms.append((time.perf_counter() - start) * 1e3)
    torch.save({**{k: v.cpu() for k, v in results.items()}, **synced_counts}, out / f"rank{rank}.pt")
    (out / f"rank{rank}.json").write_text(json.dumps({
        "launches": launches, "implied": implied, "devices": devices, "unsynced": unsynced,
        "aggregate": aggregate, "times_ms": times_ms, "reports": col.last_sync_report,
        "stages_ms": _sync_stages(col["cm"]),
    }))


def _sync_stages(cm, reps: int = 5) -> dict:
    """Median ms of each stage of one packed sync of the confusion matrix, the largest state,
    run through the same functions ``Metric.sync`` calls (both ranks run it in step)."""
    from metrics_tpu_torch.metric import _pack_state_blob, _unpack_state_blob
    from metrics_tpu_torch.parallel.backend import DistBackend, reduce_stack

    backend = DistBackend()
    stages = {"preflight": [], "pack (device to host)": [], "gather (gloo)": [],
              "unpack (host to device)": [], "reduce": []}
    for _ in range(reps):
        torch.cuda.synchronize()
        marks = [time.perf_counter()]
        backend.preflight_check(cm._schema_entries(), cm.update_count)
        marks.append(time.perf_counter())
        blob = _pack_state_blob({"r.confmat": cm.confmat})
        marks.append(time.perf_counter())
        shards = backend.all_gather_bytes(blob)
        marks.append(time.perf_counter())
        parts = [_unpack_state_blob(b)["r.confmat"].to(cm.device) for b in shards]
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        reduce_stack(torch.stack(parts), "sum")
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        for stage, (a, b) in zip(stages, zip(marks, marks[1:])):
            stages[stage].append((b - a) * 1e3)
    return {stage: statistics.median(times) for stage, times in stages.items()}


def _rank_desync(mt, rank: int, batches, out: Path) -> None:
    """Rank 1 counts 999 classes where rank 0 counts 1000: both must raise naming the peer and the state."""
    from metrics_tpu_torch.utils.exceptions import SyncDesyncError

    classes = N_CLASSES - rank
    cm = mt.ConfusionMatrix(num_classes=classes, device=DEVICE)
    for preds, target in batches[SYNC_SHARDS[rank][0] :][:2]:
        cm.update(preds[:, :classes].contiguous(), target.clamp(max=classes - 1))
    try:
        cm.compute()
        seen = {"error": None}
    except SyncDesyncError as err:
        seen = {"error": type(err).__name__, "rank": err.rank, "state": err.state, "message": str(err)}
    (out / f"rank{rank}.json").write_text(json.dumps(seen))


def _rank_stall(mt, rank: int, batches, out: Path, store) -> None:
    """Rank 1 never syncs: rank 0 must raise SyncTimeoutError within timeout x (retries + 1) plus slack."""
    from metrics_tpu_torch.utils.exceptions import SyncTimeoutError

    if rank == 0:
        col = _config2(mt, sync_timeout=SYNC_TIMEOUT)
        for preds, target in batches[:2]:
            col.update(preds, target)
        start = time.perf_counter()
        try:
            col.compute()
            seen = {"error": None}
        except SyncTimeoutError as err:
            seen = {"error": type(err).__name__, "state": err.state, "timeout": err.timeout,
                    "attempts": err.attempts, "secs": time.perf_counter() - start}
        # the group is out of step now: a later sync refuses at once, and
        # on_sync_error="local" keeps compute alive on the local state
        later = mt.SumMetric(device=DEVICE, on_sync_error="local")
        later.update(torch.tensor([1.0, 2.0], device=DEVICE))
        seen["local_value"] = float(later.compute())
        seen["local_error"] = later.last_sync_report["error"]
        (out / "rank0.json").write_text(json.dumps(seen))
    # leave together without tearing down a group whose collective was
    # abandoned: the stalled rank exits only once rank 0 is done
    store.set(f"exit/{rank}", "1")
    store.wait([f"exit/{1 - rank}"], timedelta(seconds=SYNC_LIMIT))
    sys.stdout.flush()
    os._exit(0)


def sync_rank(scenario: str, rank: int, where: Path) -> int:
    """One rank of a two-rank run on ``cuda:0`` over gloo (``--sync-rank``)."""
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    import metrics_tpu_torch as mt
    from metrics_tpu_torch.ops import stat_scores as ops

    torch.cuda.set_device(0)
    store = dist.FileStore(str(where / "store"), SYNC_WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=SYNC_WORLD,
                            timeout=timedelta(seconds=SYNC_LIMIT))
    _, _, batches = _imagenet_pass()
    if scenario == "stall":
        _rank_stall(mt, rank, batches, where, store)
    {"main": lambda: _rank_main(mt, ops, rank, batches, where),
     "desync": lambda: _rank_desync(mt, rank, batches, where),
     "curves": lambda: _rank_curves(mt, ops, rank, batches, where)}[scenario]()
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _start_ranks(scenario: str, where: Path) -> list:
    """Both ranks of one scenario, each writing its output to a log in ``where``."""
    where.mkdir()
    ranks = []
    for rank in range(SYNC_WORLD):
        log = open(where / f"log{rank}.txt", "w")
        command = [sys.executable, str(Path(__file__).resolve()), "--sync-rank", scenario, str(rank), str(where)]
        ranks.append((subprocess.Popen(command, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT), log))
    return ranks


def _wait_ranks(scenario: str, ranks: list, where: Path) -> list:
    """Each rank's JSON record; raises when a rank fails or outlives the limit (and kills it)."""
    deadline = time.monotonic() + SYNC_LIMIT
    try:
        for rank, (proc, _) in enumerate(ranks):
            try:
                code = proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"sync {scenario}: rank {rank} still runs after {SYNC_LIMIT} s") from None
            if code != 0:
                log = (where / f"log{rank}.txt").read_text()[-4000:]
                raise AssertionError(f"sync {scenario}: rank {rank} exited {code}:\n{log}")
    finally:
        for proc, log in ranks:
            proc.kill()
            proc.wait()
            log.close()
    return [json.loads(p.read_text()) if p.exists() else None
            for p in (where / f"rank{rank}.json" for rank in range(SYNC_WORLD))]


def phase_sync(single: dict, logits: torch.Tensor, labels: torch.Tensor, card: str) -> dict:
    """Two ranks on ``cuda:0`` sync config 2 and the aggregators; then the desync and stall
    scenarios, each a two-rank run of its own.  Returns the sync JSON line."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sync_") as tmp:
        tmp = Path(tmp)
        start = time.perf_counter()
        main = _wait_ranks("main", _start_ranks("main", tmp / "main"), tmp / "main")
        print(f"sync: two ranks took {time.perf_counter() - start:.1f} s (start-up included)")
        faults = {s: _start_ranks(s, tmp / s) for s in ("desync", "stall")}
        desync = _wait_ranks("desync", faults["desync"], tmp / "desync")
        stall = _wait_ranks("stall", faults["stall"], tmp / "stall")
        got = [torch.load(tmp / "main" / f"rank{rank}.pt") for rank in range(SYNC_WORLD)]

    ref = _reference(logits, labels)
    tops = logits.max(dim=1).values.cpu()
    correct = (logits.argmax(dim=1) == labels).cpu().numpy()
    batch_acc = [correct[i : i + BATCH].mean() for i in range(0, N_SAMPLES, BATCH)]
    for rank, (seen, res) in enumerate(zip(main, got)):
        if seen["launches"] != seen["implied"] or not seen["launches"]["logits"]:
            raise AssertionError(f"sync rank {rank} launched {seen['launches']}, its compute groups imply {seen['implied']}")
        if seen["devices"] != ["cuda:0"]:
            raise AssertionError(f"sync rank {rank}: results on {seen['devices']}, not the card")
        if not seen["unsynced"]:
            raise AssertionError(f"sync rank {rank}: compute() did not restore the local state")
        integers = {"cm": res["col.cm"], **{k: v for k, v in res.items() if k.split(".")[0] in ("acc", "f1", "prec")}}
        for key, want in single.items():
            if integers[key].dtype != torch.int32 or not torch.equal(integers[key], want):
                raise AssertionError(f"sync rank {rank}: {key} differs from the single-process pass")
        if not torch.equal(res["cat"], tops):
            raise AssertionError(f"sync rank {rank}: CatMetric does not hold the 50,000 top logits in rank order")
        for key in res:
            if not torch.equal(res[key], got[0][key]):
                raise AssertionError(f"sync: {key} differs between the ranks")
        _check_close(f"sync rank {rank} macro accuracy", res["col.acc"], ref["macro_acc"])
        _check_close(f"sync rank {rank} macro precision", res["col.prec"], ref["macro_precision"])
        _check_close(f"sync rank {rank} macro f1", res["col.f1"], ref["macro_f1"])
        _check_close(f"sync rank {rank} mean batch accuracy", res["mean"], ref["micro_acc"])
        _check_close(f"sync rank {rank} max batch accuracy", res["max"], max(batch_acc))
    print("check sync: both ranks bitwise equal to the single-process pass (cm, tp/fp/tn/fn), "
          "CatMetric holds the 50,000 top logits in rank order, results on cuda:0, local state restored")

    for rank, seen in enumerate(desync):
        if (seen["error"], seen.get("rank"), seen.get("state")) != ("SyncDesyncError", 1 - rank, "confmat"):
            raise AssertionError(f"sync desync: rank {rank} saw {seen}")
        print(f"check sync desync: rank {rank} raised {seen['error']}: {seen['message']}")
    seen = stall[0]
    if seen["error"] != "SyncTimeoutError" or seen["secs"] > SYNC_TIMEOUT * 1 + SYNC_SLACK:
        raise AssertionError(f"sync stall: rank 0 saw {seen}")
    if seen["local_value"] != 3.0 or not (seen["local_error"] or "").startswith("SyncError"):
        raise AssertionError(f"sync stall: a later sync did not refuse and fall back to the local state: {seen}")
    print(f"check sync stall: rank 0 raised SyncTimeoutError on {seen['state']!r} after {seen['secs']!r} s "
          f"(sync_timeout {SYNC_TIMEOUT} s, no retry); a later sync refused at once and fell back to the local state")

    aggregate = main[0]["aggregate"]
    line = {"sync": {
        "card": card,
        "transport": "gloo over one card (two ranks on cuda:0)",
        "world_size": SYNC_WORLD,
        "compute_ms_median": statistics.median(main[0]["times_ms"]),
        "compute_ms_median_per_rank": [statistics.median(seen["times_ms"]) for seen in main],
        "computes_timed": SYNC_COMPUTES,
        "bytes_gathered": aggregate["bytes_gathered"],
        "preflight_bytes": aggregate["preflight_bytes"],
        "gather_calls": aggregate["gather_calls"],
        "preflight_calls": aggregate["preflight_calls"],
        "logits_launches_per_rank": [seen["launches"]["logits"] for seen in main],
        "canonical_launches_per_rank": [seen["launches"]["canonical"] for seen in main],
        "stall_raise_secs": stall[0]["secs"],
        "confusion_matrix_sync_stages_ms": main[0]["stages_ms"],
    }}
    print(f"sync synced config-2 compute() ms, rank 0: {main[0]['times_ms']!r}")
    print(f"sync stages of one confusion-matrix sync, median ms of 5, per rank: {[seen['stages_ms'] for seen in main]!r}")
    return line



# ---------------------------------------------------------------- curves
def _curve_collection(mt):
    return mt.MetricCollection(
        {
            "auroc": mt.AUROC(num_classes=N_CLASSES, device=DEVICE),
            "ap": mt.AveragePrecision(num_classes=N_CLASSES, device=DEVICE),
            "spec": mt.Specificity(num_classes=N_CLASSES, average="macro", device=DEVICE),
            "dice": mt.Dice(num_classes=N_CLASSES, average="macro", device=DEVICE),
            "hamming": mt.HammingDistance(device=DEVICE),
            "binned_ap": mt.BinnedAveragePrecision(num_classes=N_CLASSES, thresholds=CURVE_THRESHOLDS, device=DEVICE),
        },
        device=DEVICE,
    )


def _probability_batches(batches):
    """float32 softmax probabilities of each batch's logits (per batch, as every rank takes them)."""
    return [(torch.softmax(x, dim=1), t) for x, t in batches]


CURVE_INTEGERS = {"spec": COUNTS, "dice": COUNTS, "hamming": ("correct", "total"), "binned_ap": ("TPs", "FPs", "FNs")}


def _curve_integers(col) -> dict:
    """The integer states behind the curve collection's scores, on the host."""
    return {f"{name}.{k}": getattr(col[name], k).cpu() for name, keys in CURVE_INTEGERS.items() for k in keys}


def _curve_reference(probs: torch.Tensor, labels: torch.Tensor, thresholds: torch.Tensor) -> dict:
    """Independent float64 numpy/scipy results and integer counts, on the host."""
    from scipy.stats import rankdata

    scores, target = probs.cpu().numpy(), labels.cpu().numpy()
    n, c = scores.shape
    positives = target[:, None] == np.arange(c)
    npos = positives.sum(0)
    # AUROC by the rank-sum (Mann-Whitney) formula, average ranks for ties
    ranks = rankdata(scores, axis=0)
    auroc = ((ranks * positives).sum(0) - npos * (npos + 1) / 2) / (npos * (n - npos))
    # AP as the sweep sums it: each positive adds precision at the lowest row of its tie group;
    # binned counts: rows (and positives) scoring at least each threshold
    thr = thresholds.cpu().numpy()
    ap = np.empty(c)
    tps = np.empty((c, len(thr)), np.int64)
    predicted = np.empty_like(tps)
    columns = np.sort(scores.T, axis=1)
    for k in range(c):
        column = columns[k]
        pos = np.sort(scores[target == k, k])
        ap[k] = np.mean((npos[k] - np.searchsorted(pos, pos, "left")) / (n - np.searchsorted(column, pos, "left")))
        tps[k] = npos[k] - np.searchsorted(pos, thr, "left")
        predicted[k] = n - np.searchsorted(column, thr, "left")
    fps, fns = predicted - tps, npos[:, None] - tps
    precision = np.concatenate([(tps + 1e-6) / (tps + fps + 1e-6), np.ones((c, 1))], 1)
    recall = np.concatenate([tps / (tps + fns + 1e-6), np.zeros((c, 1))], 1)
    binned_ap = -((recall[:, 1:] - recall[:, :-1]) * precision[:, :-1]).sum(1)
    pred = scores.argmax(axis=1)
    cm = np.bincount(target * c + pred, minlength=c * c).reshape(c, c)
    tp = np.diag(cm)
    fp, fn = cm.sum(0) - tp, cm.sum(1) - tp
    tn = n - tp - fp - fn
    present = (tp + fp + fn) > 0
    counts = {k: v.astype(np.int32) for k, v in zip(COUNTS, (tp, fp, tn, fn))}
    wrong = int((pred != target).sum())
    return {
        "auroc": auroc.mean(),
        "ap": ap.mean(),
        "binned_ap": binned_ap,
        "spec": (tn / (tn + fp)).mean(),
        "dice": (2 * tp / np.maximum(2 * tp + fp + fn, 1))[present].mean(),
        "hamming": 2 * wrong / (n * c),
        "integers": {
            **{f"{name}.{k}": v for name in ("spec", "dice") for k, v in counts.items()},
            "hamming.correct": np.int32(n * c - 2 * wrong), "hamming.total": np.int32(n * c),
            "binned_ap.TPs": tps, "binned_ap.FPs": fps, "binned_ap.FNs": fns,
        },
    }


def _check_curve_results(name: str, out: dict, integers: dict, ref: dict) -> None:
    for key, want in ref["integers"].items():
        got = integers[key].numpy()
        if not np.array_equal(got, want) or (got.dtype != np.float32 and got.dtype != want.dtype):
            raise AssertionError(f"{name}: {key} differs from numpy's counts")
    print(f"check {name} integer states: tp/fp/tn/fn of spec and dice, hamming's correct/total and the "
          f"binned TPs/FPs/FNs bitwise equal to numpy's counts")
    for key in ("auroc", "ap"):
        value = float(out[key])
        if not np.isclose(value, ref[key], rtol=CURVE_RTOL, atol=0.0):
            raise AssertionError(f"{name} {key}: port {value!r} vs numpy/scipy {ref[key]!r}")
        print(f"check {name} {key}: {value!r} (numpy/scipy {ref[key]!r}, rtol {CURVE_RTOL})")
    binned = torch.stack(list(out["binned_ap"])).cpu().numpy().astype(np.float64)
    worst = float(np.abs(binned - ref["binned_ap"]).max())
    if binned.shape != ref["binned_ap"].shape or worst > BINNED_ATOL:
        raise AssertionError(f"{name} binned AP: largest difference {worst!r} from numpy's > {BINNED_ATOL}")
    print(f"check {name} binned AP per class: largest difference {worst!r} from numpy's (atol {BINNED_ATOL})")
    for key, rtol, atol in (("spec", FLOAT_RTOL, 0.0), ("dice", FLOAT_RTOL, 0.0), ("hamming", 0.0, HAMMING_ATOL)):
        value = float(out[key])
        if not np.isclose(value, ref[key], rtol=rtol, atol=atol):
            raise AssertionError(f"{name} {key}: port {value!r} vs numpy {ref[key]!r}")
        print(f"check {name} {key}: {value!r} (numpy {ref[key]!r})")


def _same_values(a, b) -> bool:
    """Same dtype, shape and values, bit for bit except the payload of a NaN (a NaN that
    passes through arithmetic comes out canonical on the GPU, as it came in on the CPU)."""
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(_same_values(x, y) for x, y in zip(a, b))
    a, b = a.cpu(), b.cpu()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    width = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(a[~nan].view(width), b[~nan].view(width))


def _tricky_scores(shape, seed: int) -> np.ndarray:
    """Scores on a grid of eighths in [-1, 1] (most rows tie), with NaNs, signed zeros and infinities."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-8, 9, shape) / 8).astype(np.float32)
    flat = x.reshape(-1)
    flat[rng.choice(flat.size, 24, replace=False)] = np.nan
    flat[rng.choice(flat.size, 24, replace=False)] = -0.0
    flat[rng.choice(flat.size, 24, replace=False)] = 0.0
    flat[rng.choice(flat.size, 6, replace=False)] = np.inf
    flat[rng.choice(flat.size, 6, replace=False)] = -np.inf
    return x


def _card_vs_plain_curves(mt) -> int:
    """The card's exact curves against the plain CPU path on the same inputs; returns the number of tensors compared."""
    f = mt.functional
    n, c = 515, 7
    rng = np.random.default_rng(SEED + 7)
    cases = {
        "binary": (_tricky_scores(n, 1), rng.integers(0, 2, n), {"pos_label": 1}),
        "multi-class": (_tricky_scores((n, c), 2), rng.integers(0, c, n), {"num_classes": c}),
        "multi-label": (_tricky_scores((n, c), 3), rng.integers(0, 2, (n, c)), {"num_classes": c}),
    }
    calls = {
        "roc": lambda p, t, kw: f.roc(p, t, **kw),
        "precision_recall_curve": lambda p, t, kw: f.precision_recall_curve(p, t, **kw),
    }
    compared = 0
    for case, (scores, target, kwargs) in cases.items():
        runs = dict(calls)
        if case == "binary":
            for max_fpr in (0.1, 0.5):
                runs[f"auroc max_fpr={max_fpr}"] = lambda p, t, kw, m=max_fpr: f.auroc(p, t, max_fpr=m, **kw)
        for name, call in runs.items():
            cpu = call(torch.from_numpy(scores), torch.from_numpy(target), kwargs)
            card = call(torch.from_numpy(scores).to(DEVICE), torch.from_numpy(target).to(DEVICE), kwargs)
            torch.cuda.synchronize()
            leaves = [card] if isinstance(card, torch.Tensor) else [x for part in card for x in (part if isinstance(part, list) else [part])]
            if any(x.device.type != torch.device(DEVICE).type for x in leaves) or not _same_values(card, cpu):
                raise AssertionError(f"{name} on {case} scores: the card's result differs from the plain CPU path")
            compared += len(leaves)
            print(f"check card vs plain: {name} on {case} scores with ties, +-0.0, NaN and +-inf: bitwise equal")
    return compared


def _append_counter(mt):
    """Count each metric's buffer appends (by instance) while installed."""
    original = mt.Metric._buffer_append
    seen: dict = {}

    def counting(self, name, values):
        seen[id(self)] = seen.get(id(self), 0) + 1
        return original(self, name, values)

    return original, counting, seen


def _ops_by_name(fn) -> list:
    """(name, total device ms, count) of the device operations one call of ``fn`` issues, largest first."""
    seen = _device_ops(fn) or []
    totals: dict = {}
    for name, ms in seen:
        key = name.split("<")[0].split("(")[0][-60:]
        total, count = totals.get(key, (0.0, 0))
        totals[key] = (total + ms, count + 1)
    return sorted(((k, t, n) for k, (t, n) in totals.items()), key=lambda row: -row[1])


def phase_curves(mt, ops, logits: torch.Tensor, labels: torch.Tensor, card: str) -> Tuple[dict, dict]:
    """The curve phase; returns each entry point's launches in its run and the curve JSON line."""
    batches = _probability_batches([(logits[i : i + BATCH], labels[i : i + BATCH]) for i in range(0, N_SAMPLES, BATCH)])
    probs = torch.cat([p for p, _ in batches])
    n_batches = len(batches)
    compared = _card_vs_plain_curves(mt)

    warm = _curve_collection(mt)  # loads the CUDA modules of every op on the path
    for preds, target in batches[:2]:
        warm.update(preds, target)
    warm.compute()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()

    col = _curve_collection(mt)
    original, counting, appends = _append_counter(mt)
    mt.Metric._buffer_append = counting

    def run():
        for preds, target in batches:
            col.update(preds, target)
        return col.compute()

    try:
        out, secs, counts = _driven(ops, "curves", run, lambda: _implied_config2(ops, col, n_batches))
    finally:
        mt.Metric._buffer_append = original
    peak_bytes = torch.cuda.max_memory_allocated() - base_bytes
    groups = sorted(sorted(g) for g in col.compute_groups.values())
    if groups != [["ap", "auroc"], ["binned_ap"], ["dice", "spec"], ["hamming"]]:
        raise AssertionError(f"curve compute groups {groups}")
    shared = all(getattr(col["ap"], k) is getattr(col["auroc"], k) for k in ("preds__buf", "target__buf"))
    per_metric = {name: appends.get(id(m), 0) for name, m in col.items(keep_base=True) if appends.get(id(m))}
    leader = col.compute_groups[next(i for i, g in col.compute_groups.items() if "auroc" in g)][0]
    implied_appends = {"ap": 2, "auroc": 2}
    implied_appends[leader] += 2 * (n_batches - 1)
    print(f"curve buffer appends per metric: {per_metric} (the group implies {implied_appends}); "
          f"AUROC and AveragePrecision share one preds/target buffer pair: {shared}")
    if not shared or per_metric != implied_appends:
        raise AssertionError("AUROC and AveragePrecision do not share one pair of buffers, appended once per batch")
    rows = col["auroc"].preds__len
    if rows != N_SAMPLES or tuple(col["auroc"].preds__buf.shape) != (65536, N_CLASSES):
        raise AssertionError(f"the preds buffer holds {rows} rows in {tuple(col['auroc'].preds__buf.shape)}")

    ref = _curve_reference(probs, labels, col["binned_ap"].thresholds)
    integers = _curve_integers(col)
    _check_curve_results("curves", out, integers, ref)

    def timed_compute(metric) -> list:
        times = []
        for _ in range(CURVE_COMPUTES):
            metric._computed = None
            torch.cuda.synchronize()
            start = time.perf_counter()
            metric.compute()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3)
        return times

    auroc_ms, ap_ms = timed_compute(col["auroc"]), timed_compute(col["ap"])
    binned = mt.BinnedAveragePrecision(num_classes=N_CLASSES, thresholds=CURVE_THRESHOLDS, device=DEVICE)
    binned_ms = _call_ms(lambda: binned.update(*batches[0]), reps=20, warmup=3)
    auroc = mt.AUROC(num_classes=N_CLASSES, device=DEVICE)
    auroc_update_ms = _call_ms(lambda: auroc.update(*batches[0]), reps=20, warmup=3)
    update_ops = _device_ops(lambda: auroc.update(*batches[0])) or []
    reads = sum("DtoH" in name for name, _ in update_ops)
    compute_ops = _ops_by_name(lambda: col["auroc"]._compute_impl())
    print(f"curve pass samples/s: {N_SAMPLES / secs!r} ({secs!r} s, update per batch + compute of all six members)")
    print(f"curve compute() ms at {(N_SAMPLES, N_CLASSES)}, {CURVE_COMPUTES} calls: AUROC {auroc_ms!r}, "
          f"AveragePrecision {ap_ms!r}")
    print(f"BinnedAveragePrecision update ms per batch of {BATCH}, {CURVE_THRESHOLDS} thresholds: {binned_ms!r}")
    print(f"AUROC update ms per batch of {BATCH} (a buffer append): {auroc_update_ms!r}; device operations "
          f"{len(update_ops)}, device->host copies {reads} (0: not counted where the profiler saw no device activity)")
    print(f"AUROC compute() device operations by total device ms: "
          f"{[(name, round(ms, 3), count) for name, ms, count in compute_ops[:10]]!r}")
    print(f"curve phase peak device memory above its start: {peak_bytes} bytes")

    sync = phase_curve_sync(out, integers, ref, probs.shape)
    line = {"curves": {
        "card": card,
        "samples_per_s": N_SAMPLES / secs,
        "auroc_compute_ms": auroc_ms,
        "ap_compute_ms": ap_ms,
        "binned_update_ms": binned_ms,
        "auroc_update_ms": auroc_update_ms,
        "auroc_update_device_to_host_copies": reads,
        "peak_bytes": peak_bytes,
        "launches": counts,
        "buffer_appends": per_metric,
        "card_vs_plain_tensors": compared,
        **sync,
    }}
    return counts, line


def _rank_curves(mt, ops, rank: int, batches, out: Path) -> None:
    """This rank's share of the curve pass, then a synced compute of the collection."""
    probs = _probability_batches(batches)
    col = _curve_collection(mt)
    first, stop = SYNC_SHARDS[rank]
    for fn in _counters(ops).values():
        fn.launches = 0
    for preds, target in probs[first:stop]:
        col.update(preds, target)
    torch.cuda.synchronize()
    launches = {route: fn.launches for route, fn in _counters(ops).items()}
    implied = _implied_config2(ops, col, stop - first)
    local = col["auroc"].buffer_values("preds").clone()
    start = time.perf_counter()
    results = col.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - start) * 1e3
    aggregate = col.aggregate_sync_report()
    with col["auroc"].sync_context():  # the gathered rows, in rank order, against the whole pass
        rows_equal = torch.equal(col["auroc"].buffer_values("preds"), torch.cat([p for p, _ in probs])) and torch.equal(
            col["auroc"].buffer_values("target"), torch.cat([t for _, t in probs]).to(torch.int32))
    restored = torch.equal(col["auroc"].buffer_values("preds"), local) and not any(m._is_synced for m in col.values())
    synced = {}
    for name, keys in CURVE_INTEGERS.items():  # the integer states, as synced
        with col[name].sync_context():
            synced.update({f"{name}.{k}": getattr(col[name], k).cpu() for k in keys})
    torch.save({**{k: v.cpu() for k, v in results.items() if k != "binned_ap"},
                "binned_ap": torch.stack(list(results["binned_ap"])).cpu(), **synced}, out / f"rank{rank}.pt")
    (out / f"rank{rank}.json").write_text(json.dumps({
        "launches": launches, "implied": implied, "rows_equal": rows_equal, "restored": restored,
        "compute_ms": compute_ms, "aggregate": aggregate,
    }))


def phase_curve_sync(single: dict, single_integers: dict, ref: dict, shape) -> dict:
    """Two ranks on ``cuda:0`` sync the curve collection; both must equal the single-process pass."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_curves_") as tmp:
        tmp = Path(tmp)
        start = time.perf_counter()
        seen = _wait_ranks("curves", _start_ranks("curves", tmp / "curves"), tmp / "curves")
        print(f"curve sync: two ranks took {time.perf_counter() - start:.1f} s (start-up included)")
        got = [torch.load(tmp / "curves" / f"rank{rank}.pt") for rank in range(SYNC_WORLD)]
    want = {key: value.cpu() for key, value in single.items() if key != "binned_ap"}
    want["binned_ap"] = torch.stack(list(single["binned_ap"])).cpu()
    want.update(single_integers)
    for rank, (info, res) in enumerate(zip(seen, got)):
        if info["launches"] != info["implied"] or not info["launches"]["logits"]:
            raise AssertionError(f"curve sync rank {rank} launched {info['launches']}, its groups imply {info['implied']}")
        if not info["rows_equal"]:
            raise AssertionError(f"curve sync rank {rank}: the gathered buffer rows are not the pass's rows in order")
        if not info["restored"]:
            raise AssertionError(f"curve sync rank {rank}: compute() did not restore the local buffers")
        for key, value in want.items():
            if not _same_values(res[key], value):
                raise AssertionError(f"curve sync rank {rank}: {key} differs from the single-process pass")
        _check_curve_results(f"curve sync rank {rank}", {**res, "binned_ap": list(res["binned_ap"])},
                             {k: v for k, v in res.items() if "." in k}, ref)
    print(f"check curve sync: both ranks hold the {N_SAMPLES:,} rows in rank order and equal the single-process pass "
          "bitwise (AUROC, AP, binned AP, spec, dice, hamming and their integer states)")
    aggregate = seen[0]["aggregate"]
    print(f"curve sync: synced compute() ms per rank {[info['compute_ms'] for info in seen]!r}, "
          f"bytes_gathered {aggregate['bytes_gathered']} (rank 0, all members), gather calls {aggregate['gather_calls']}")
    return {
        "sync_compute_ms_per_rank": [info["compute_ms"] for info in seen],
        "sync_bytes_gathered": aggregate["bytes_gathered"],
        "sync_gather_calls": aggregate["gather_calls"],
        "sync_logits_launches_per_rank": [info["launches"]["logits"] for info in seen],
        "preds_rows": shape[0],
    }


# ------------------------------------------------------ rest of classification
def _confmat_collection(mt):
    return mt.MetricCollection(
        {
            "cm": mt.ConfusionMatrix(num_classes=N_CLASSES, device=DEVICE),
            "jaccard": mt.JaccardIndex(num_classes=N_CLASSES, device=DEVICE),
            "mcc": mt.MatthewsCorrCoef(num_classes=N_CLASSES, device=DEVICE),
            "kappa": mt.CohenKappa(num_classes=N_CLASSES, device=DEVICE),
            "ce": mt.CalibrationError(n_bins=CE_BINS, norm="l1", device=DEVICE),
        },
        device=DEVICE,
    )


def _hinge_collection(mt):
    return mt.MetricCollection(
        {"hinge": mt.HingeLoss(device=DEVICE),
         "hinge_ova_sq": mt.HingeLoss(squared=True, multiclass_mode="one-vs-all", device=DEVICE)},
        device=DEVICE,
    )


def _kl_collection(mt):
    return mt.MetricCollection(
        {"kl": mt.KLDivergence(device=DEVICE),
         "kl_log_none": mt.KLDivergence(log_prob=True, reduction="none", device=DEVICE)},
        device=DEVICE,
    )


def _ranking_collection(mt):
    return mt.MetricCollection(
        {"coverage": mt.CoverageError(device=DEVICE), "lrap": mt.LabelRankingAveragePrecision(device=DEVICE),
         "lrl": mt.LabelRankingLoss(device=DEVICE)},
        device=DEVICE,
    )


def _teacher_logits(labels: torch.Tensor) -> torch.Tensor:
    """A second classifier's float32 logits on the pass (a distillation teacher), from its own seed."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    logits = torch.randn((N_SAMPLES, N_CLASSES), generator=gen, device=DEVICE)
    return logits.scatter_add_(1, labels[:, None], torch.full((N_SAMPLES, 1), 2.5, device=DEVICE))


def _coco_pass():
    """A multilabel pass of the shape of MS-COCO 2014 val: 40,504 images x 80 labels, every image
    with at least one label and 2.9 on average (1 + Poisson(1.9)), labels drawn with a skewed
    frequency (weights 1 / rank**0.8, as a few classes dominate COCO), float32 scores from a
    sigmoid of a noisy margin, and float32 per-sample weights in [0.5, 1.5); from the seed,
    built on the host in bulk and moved to the card once."""
    rng = np.random.default_rng(SEED + 11)
    n, c = N_COCO, N_LABELS
    counts = np.minimum(1 + rng.poisson(COCO_LABELS_MEAN - 1, n), c)
    keys = np.log(1.0 / np.arange(1, c + 1) ** 0.8)[rng.permutation(c)] + rng.gumbel(size=(n, c))
    ranks = np.argsort(np.argsort(-keys, axis=1), axis=1)  # Gumbel top-k: k labels without replacement
    target = (ranks < counts[:, None]).astype(np.int64)
    scores = (1 / (1 + np.exp(-(rng.standard_normal((n, c)) + 2.0 * target - 1.0)))).astype(np.float32)
    weights = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return tuple(torch.from_numpy(x).to(DEVICE) for x in (scores, target, weights))


def _ranking_reference(scores: np.ndarray, target: np.ndarray, weights: np.ndarray) -> dict:
    """Independent float64 numpy/scipy values: coverage from each row's lowest relevant score,
    LRAP from scipy's 'min' ranks (ties count as ranked at or above), the ranking loss from a
    stable sort (a tie is ordered wrong when the irrelevant label comes later in the row)."""
    from scipy.stats import rankdata

    s = scores.astype(np.float64)
    rel = target == 1
    n, c = s.shape
    n_rel = rel.sum(1)
    lowest = np.where(rel, s, np.inf).min(1)
    coverage = (s >= lowest[:, None]).sum(1).astype(np.float64)
    rank_all = c + 1 - rankdata(s, method="min", axis=1)
    rank_rel = c + 1 - rankdata(np.where(rel, s, -np.inf), method="min", axis=1)
    ratios = np.where(rel, rank_rel / rank_all, 0.0).sum(1) / np.maximum(n_rel, 1)
    lrap = np.where((n_rel > 0) & (n_rel < c), ratios, 1.0)
    order = np.argsort(s, axis=1, kind="stable")
    rel_sorted = np.take_along_axis(rel, order, axis=1)
    irr_after = np.cumsum((~rel_sorted)[:, ::-1], axis=1)[:, ::-1] - ~rel_sorted  # irrelevant labels later in the row
    wrong = (rel_sorted * irr_after).sum(1)
    lrl = np.where((n_rel > 0) & (n_rel < c), wrong / np.maximum(n_rel * (c - n_rel), 1), 0.0)
    w = weights.astype(np.float64)
    out = {}
    for name, per_row in (("coverage", coverage), ("lrap", lrap), ("lrl", lrl)):
        out[name] = per_row.mean()
        out[f"{name} weighted"] = (per_row * w).sum() / w.sum()
    return out


def _check_rest_close(name: str, got, expected: float, rtol: float = FLOAT_RTOL, atol: float = 0.0) -> dict:
    value = float(got)
    if not np.isclose(value, expected, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: port {value!r} vs numpy {expected!r} (rtol {rtol}, atol {atol})")
    print(f"check {name}: {value!r} (numpy {expected!r}, rtol {rtol}, atol {atol!r})")
    return {"port": value, "numpy": float(expected)}


def _confmat_reference(cm: np.ndarray) -> dict:
    """Jaccard (macro), MCC and kappa (each weighting) in float64 from the int confusion matrix,
    with the tolerance each float32 value is held to."""
    cm = cm.astype(np.float64)
    tp, rows, cols, s = np.diag(cm), cm.sum(1), cm.sum(0), cm.sum()
    union = rows + cols - tp
    jaccard = np.where(union == 0, 0.0, tp / np.where(union == 0, 1.0, union)).mean()
    denom = (s * s - (cols * cols).sum()) * (s * s - (rows * rows).sum())
    mcc = (tp.sum() * s - (rows * cols).sum()) / np.sqrt(denom)
    out = {"jaccard": (jaccard, FLOAT_RTOL, 0.0),
           # c * s, s**2 and the sums near s**2 each carry up to s**2 * 2**-24 of float32 rounding
           "mcc": (mcc, 0.0, MCC_ATOL_UNITS * s * s * 2.0**-24 / np.sqrt(denom))}
    expected = np.outer(rows, cols) / s
    i = np.arange(cm.shape[0], dtype=np.float64)
    for weights, w in ((None, 1.0 - np.eye(cm.shape[0])), ("linear", np.abs(i[:, None] - i)),
                       ("quadratic", (i[:, None] - i) ** 2)):
        k = (w * cm).sum() / (w * expected).sum()
        # kappa is 1 - k, k a quotient of two float32 sums of 10**6 terms on the card
        out[f"kappa {weights}"] = (1 - k, 0.0, KAPPA_ATOL_UNITS * 2.0**-24 * abs(k))
    return out


def _ce_reference(probs: np.ndarray, labels: np.ndarray, edges: np.ndarray) -> dict:
    """float64 expected calibration error on the same float32 confidences and edges; per-bin counts."""
    conf = probs.max(1)
    acc = (probs.argmax(1) == labels).astype(np.float64)
    idx = np.clip(np.searchsorted(edges, conf, side="left") - 1, 0, len(edges) - 2)
    counts = np.bincount(idx, minlength=len(edges) - 1)
    per = np.maximum(counts, 1)
    gap = np.abs(np.bincount(idx, acc, len(edges) - 1) / per - np.bincount(idx, conf.astype(np.float64), len(edges) - 1) / per)
    return {"conf": conf, "acc": acc.astype(np.float32), "counts": counts, "ece": (gap * counts).sum() / counts.sum()}


def _hinge_kl_reference(logits: np.ndarray, labels: np.ndarray, p: np.ndarray, q: np.ndarray,
                        lp: np.ndarray, lq: np.ndarray) -> dict:
    """float64 hinge losses and KL divergences on the same float32 inputs, row by row, with each
    KL row's sum of term magnitudes (its float32 rounding scales with it, not with the sum)."""
    n = len(labels)
    x = logits.astype(np.float64)
    rows = np.arange(n)
    true = x[rows, labels]
    x[rows, labels] = -np.inf
    crammer = np.maximum(1 - (true - x.max(1)), 0).mean()
    x[rows, labels] = true
    onehot = np.zeros(x.shape, bool)
    onehot[rows, labels] = True
    ova = (np.maximum(1 - np.where(onehot, x, -x), 0) ** 2).sum(0) / n
    del x
    p64, q64 = p.astype(np.float64), q.astype(np.float64)
    p64 /= p64.sum(1, keepdims=True)
    q64 /= q64.sum(1, keepdims=True)
    terms = p64 * np.log(p64 / q64)
    kl_rows, kl_scale = terms.sum(1), np.abs(terms).sum(1)
    lp64, lq64 = lp.astype(np.float64), lq.astype(np.float64)
    terms = np.exp(lp64) * (lp64 - lq64)
    return {"hinge": crammer, "hinge_ova_sq": ova, "kl": kl_rows.mean(), "kl_scale": kl_scale.mean(),
            "kl_log_rows": terms.sum(1), "kl_log_scale": np.abs(terms).sum(1)}


def _rest_inputs(n: int, c: int, seed: int):
    """Small inputs with ties, +-0.0, NaN and +-inf: scores, labels, multilabel targets (a row with
    no relevant label and one with every label relevant), weights, and confidences on bin edges."""
    rng = np.random.default_rng(seed)
    scores = _tricky_scores((n, c), seed)
    labels = rng.integers(0, c, n)
    labels[:3] = (c, -1, c + 4)  # out of range: hinge's one-hot row is all zero
    multilabel = rng.integers(0, 2, (n, c))
    multilabel[0], multilabel[1] = 0, 1
    weights = (rng.random(n) + 0.5).astype(np.float32)
    edges = _linspace_edges(CE_BINS)
    conf = np.concatenate([edges, np.nextafter(edges, 2), [np.nan, -0.0, 0.0, 1.5, -0.5, np.inf],
                           rng.random(n)]).astype(np.float32)
    with np.errstate(invalid="ignore"):  # a row holding an infinity gives NaNs
        probs = np.abs(scores) / np.nansum(np.abs(scores), 1, keepdims=True)
    probs[rng.choice(n, 5, replace=False), rng.integers(0, c, 5)] = np.nan  # the first NaN of a row wins its argmax
    probs[2] = probs[2, 0]  # a row of tied maxima
    return scores, labels, multilabel, weights, conf, probs.astype(np.float32)


def _linspace_edges(n_bins: int) -> np.ndarray:
    from metrics_tpu_torch.utils.data import _linspace_thresholds

    return _linspace_thresholds(n_bins + 1)


def _card_vs_cpu_rest(mt) -> dict:
    """The card's ranking, calibration and hinge functionals against the plain CPU path on the same
    small inputs.  Bitwise where no float sum runs in a device-dependent order: rank positions, rank
    counts, each row's coverage and ranking loss, the unweighted coverage (a sum of integers), bin
    indices and counts, top-1 confidences and hits, and each sample's hinge loss.  The rest (float32
    sums over rows, float64 bin sums rounded to float32) to ``rtol=1e-6``, NaN as NaN.  The ranking
    and hinge calls run on the tricky scores and again with their NaNs and ``-inf`` replaced (one NaN
    or ``-inf`` in a batch sets every row's coverage to 0, as in the JAX package).  Returns how
    many tensors each way compared."""
    from metrics_tpu_torch.functional.classification import ranking as rk
    from metrics_tpu_torch.functional.classification.calibration_error import _bin_indices, _ce_update
    from metrics_tpu_torch.functional.classification.hinge import _hinge_measures

    f = mt.functional
    scores, labels, multilabel, weights, conf, probs = _rest_inputs(515, 7, SEED + 13)
    finite = np.where(np.isnan(scores) | (scores == -np.inf), np.float32(0.25), scores)
    edges = torch.from_numpy(_linspace_edges(CE_BINS))
    hits = np.arange(conf.size) % 2
    # (scores, multilabel targets, weights, labels) -> tensors
    bitwise = {
        "rank positions": lambda s, t, w, y: rk._rank_inverse(s),
        "LRAP rank counts": lambda s, t, w, y: rk._lrap_ranks(s, t == 1),
        "coverage per row": lambda s, t, w, y: rk._coverage_per_sample(s, t),
        "ranking loss per row": lambda s, t, w, y: rk._lrl_per_sample(s, t),
        "coverage_error": lambda s, t, w, y: f.coverage_error(s, t),
    }
    for squared in (False, True):
        for mode in (None, "one-vs-all"):
            bitwise[f"hinge per sample, {mode or 'crammer-singer'}, squared={squared}"] = (
                lambda s, t, w, y, sq=squared, m=mode: _hinge_measures(s, y, sq, m))
    close = {
        "label_ranking_loss": lambda s, t, w, y: f.label_ranking_loss(s, t),
        "label_ranking_loss weighted": lambda s, t, w, y: f.label_ranking_loss(s, t, sample_weight=w),
        "label_ranking_average_precision": lambda s, t, w, y: f.label_ranking_average_precision(s, t),
        "label_ranking_average_precision weighted": lambda s, t, w, y: f.label_ranking_average_precision(s, t, sample_weight=w),
        "coverage_error weighted": lambda s, t, w, y: f.coverage_error(s, t, sample_weight=w),
        "LRAP per row": lambda s, t, w, y: rk._lrap_per_sample(s, t),
        "hinge_loss crammer-singer": lambda s, t, w, y: f.hinge_loss(s, y),
        "hinge_loss one-vs-all squared": lambda s, t, w, y: f.hinge_loss(s, y, squared=True, multiclass_mode="one-vs-all"),
    }
    calibration_bitwise = {
        "bin indices": lambda d: _bin_indices(torch.from_numpy(conf).to(d), edges.to(d)),
        "bin counts": lambda d: torch.bincount(_bin_indices(torch.from_numpy(conf).to(d), edges.to(d)), minlength=CE_BINS),
        "top-1 confidences and hits": lambda d: _ce_update(torch.from_numpy(probs).to(d), torch.from_numpy(labels.clip(0, 6)).to(d)),
    }
    calibration_close = {}
    for norm in ("l1", "l2", "max"):
        for case, (p, t) in {"confidences on bin edges, NaN, +-0.0 and past 1": (conf, hits),
                             "probabilities with NaN and tied maxima": (probs, labels.clip(0, 6))}.items():
            calibration_close[f"calibration_error {norm}, {case}"] = (
                lambda d, p=p, t=t, n=norm: f.calibration_error(torch.from_numpy(p).to(d), torch.from_numpy(t).to(d), n_bins=CE_BINS, norm=n))

    def leaves(x):
        return [x] if isinstance(x, torch.Tensor) else [y for part in x for y in leaves(part)]

    def same(name, got, want, exact: bool) -> int:
        torch.cuda.synchronize()
        got, want = leaves(got), leaves(want)
        if any(x.device.type != torch.device(DEVICE).type for x in got):
            raise AssertionError(f"{name}: the card's result is not on the card")
        ok = _same_values(got, want) if exact else len(got) == len(want) and all(
            g.dtype == w.dtype and g.shape == w.shape and torch.allclose(g.cpu(), w, rtol=1e-6, atol=0.0, equal_nan=True)
            for g, w in zip(got, want))
        if not ok:
            raise AssertionError(f"{name}: the card's result differs from the plain CPU path")
        print(f"check card vs plain: {name}: {'bitwise equal' if exact else 'equal to rtol 1e-6 (NaN as NaN)'}")
        return len(got)

    compared = {"bitwise": 0, "rtol": 0}
    for case, s in {"ties, +-0.0, NaN and +-inf": scores, "ties, +-0.0 and +inf": finite}.items():
        cpu_in = tuple(torch.from_numpy(x) for x in (s, multilabel, weights, labels))
        card_in = tuple(x.to(DEVICE) for x in cpu_in)
        for table, key in ((bitwise, "bitwise"), (close, "rtol")):
            for name, call in table.items():
                compared[key] += same(f"{name} on {case}", call(*card_in), call(*cpu_in), key == "bitwise")
    for table, key in ((calibration_bitwise, "bitwise"), (calibration_close, "rtol")):
        for name, call in table.items():
            compared[key] += same(name, call(torch.device(DEVICE)), call(torch.device("cpu")), key == "bitwise")
    return compared


def _member_timings(members: dict) -> dict:
    """ms per update of each metric at full width (median of 20 on an idle card, the host's launch
    work included), and the device operations and device->host copies of one update: the most that
    any of ``PROFILER_ATTEMPTS`` profiler sessions recorded, since a session may drop events."""
    out = {}
    for name, (metric, args) in members.items():
        ms = _call_ms(lambda: metric.update(*args), reps=20, warmup=3)
        seen = max(((_device_ops(lambda: metric.update(*args)) or []) for _ in range(PROFILER_ATTEMPTS)), key=len)
        out[name] = {"update_ms": ms, "device_ops": len(seen), "device_to_host": sum("DtoH" in op for op, _ in seen)}
        print(f"{name} update at full width: {ms!r} ms (median of 20), {len(seen)} device operations, "
              f"{out[name]['device_to_host']} device->host copies (0: not counted where the profiler saw no device activity)")
    return out


def _timed_compute(col, reps: int = 3) -> list:
    times = []
    for _ in range(reps):
        for m in col.values():
            m._computed = None
        torch.cuda.synchronize()
        start = time.perf_counter()
        col.compute()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return times


def _timed_pass(col, batches) -> Tuple[dict, float]:
    """One update per batch and the final compute, synchronised; returns the results and the seconds."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    for args in batches:
        col.update(*args)
    out = col.compute()
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


def phase_rest(mt, ops, logits: torch.Tensor, labels: torch.Tensor, card: str) -> Tuple[dict, dict]:
    """The rest of classification: the confusion-matrix family and calibration on the ImageNet
    pass's probabilities, hinge and KL on its logits, the ranking metrics on a COCO-shaped
    multilabel pass, the card against the CPU on small tricky inputs, and timings.  None of these
    metrics goes through the stat-scores kernel: both entry points must stay at 0 launches."""
    phase_start = time.perf_counter()
    for fn in _counters(ops).values():
        fn.launches = 0
    batch_slices = [slice(i, i + BATCH) for i in range(0, N_SAMPLES, BATCH)]
    probs = [torch.softmax(logits[s], dim=1) for s in batch_slices]
    teacher = _teacher_logits(labels)
    checks = {}

    # (a) the confusion-matrix family and calibration on the probabilities
    warm = _confmat_collection(mt)  # loads the CUDA modules of every op on the path
    for s, p in zip(batch_slices[:2], probs[:2]):
        warm.update(p, labels[s])
    warm.compute()
    col_a = _confmat_collection(mt)
    out_a, secs_a = _timed_pass(col_a, [(p, labels[s]) for s, p in zip(batch_slices, probs)])
    groups = sorted(sorted(g) for g in col_a.compute_groups.values())
    if groups != [["ce"], ["cm", "jaccard", "kappa", "mcc"]]:
        raise AssertionError(f"confusion-matrix family compute groups {groups}")
    if not all(col_a[k].confmat is col_a["cm"].confmat for k in ("jaccard", "mcc", "kappa")):
        raise AssertionError("the confusion-matrix family does not share one confmat")
    probs_host, labels_host = torch.cat(probs).cpu().numpy(), labels.cpu().numpy()
    cm_ref = np.bincount(labels_host * N_CLASSES + probs_host.argmax(1), minlength=N_CLASSES**2).reshape(N_CLASSES, N_CLASSES)
    cm = out_a["cm"].cpu().numpy()
    if cm.dtype != np.int32 or not np.array_equal(cm, cm_ref):
        raise AssertionError("the family's confusion matrix differs from numpy's bincount")
    print("check rest cm: bitwise equal to numpy bincount; groups {cm, jaccard, mcc, kappa} and {ce}")
    from metrics_tpu_torch.functional.classification.calibration_error import _bin_indices
    from metrics_tpu_torch.functional.classification.cohen_kappa import _cohen_kappa_compute

    scores = {"jaccard": out_a["jaccard"], "mcc": out_a["mcc"], "kappa None": out_a["kappa"]}
    for weights in ("linear", "quadratic"):
        scores[f"kappa {weights}"] = _cohen_kappa_compute(col_a["kappa"].confmat, weights)
    for name, (want, rtol, atol) in _confmat_reference(cm).items():
        checks[name] = _check_rest_close(name, scores[name], want, rtol, atol)
    ce_ref = _ce_reference(probs_host, labels_host, col_a["ce"].bin_boundaries.cpu().numpy())
    conf, acc = torch.cat(col_a["ce"].confidences), torch.cat(col_a["ce"].accuracies)
    counts = torch.bincount(_bin_indices(conf, col_a["ce"].bin_boundaries), minlength=CE_BINS).cpu().numpy()
    if not (np.array_equal(conf.cpu().numpy(), ce_ref["conf"]) and np.array_equal(acc.cpu().numpy(), ce_ref["acc"])
            and np.array_equal(counts, ce_ref["counts"])):
        raise AssertionError("calibration: confidences, hits or per-bin counts differ from numpy's")
    print(f"check rest calibration: {N_SAMPLES:,} confidences and hits and the per-bin counts {counts.tolist()} bitwise equal to numpy's")
    # 15 bins of |accuracy - confidence| x proportion, each gap a difference of two float32 quotients
    checks["ece"] = _check_rest_close("ece (l1, 15 bins)", out_a["ce"], ce_ref["ece"], FLOAT_RTOL, ECE_ATOL)

    # (b) hinge and KL on the logits
    col_h, col_k = _hinge_collection(mt), _kl_collection(mt)
    kl_inputs = [(torch.softmax(logits[s], 1), torch.softmax(teacher[s], 1)) for s in batch_slices]
    kl_log_inputs = [(torch.log_softmax(logits[s], 1), torch.log_softmax(teacher[s], 1)) for s in batch_slices]
    out_h, secs_h = _timed_pass(col_h, [(logits[s], labels[s]) for s in batch_slices])
    torch.cuda.synchronize()
    start = time.perf_counter()
    for (p, q), (lp, lq) in zip(kl_inputs, kl_log_inputs):
        col_k["kl"].update(p, q)
        col_k["kl_log_none"].update(lp, lq)
    out_k = col_k.compute()
    torch.cuda.synchronize()
    secs_k = time.perf_counter() - start
    ref_b = _hinge_kl_reference(
        logits.cpu().numpy(), labels_host, torch.cat([p for p, _ in kl_inputs]).cpu().numpy(),
        torch.cat([q for _, q in kl_inputs]).cpu().numpy(), torch.cat([p for p, _ in kl_log_inputs]).cpu().numpy(),
        torch.cat([q for _, q in kl_log_inputs]).cpu().numpy())
    checks["hinge"] = _check_rest_close("hinge (crammer-singer)", out_h["hinge"], ref_b["hinge"])
    ova = out_h["hinge_ova_sq"].cpu().numpy().astype(np.float64)
    worst = float(np.max(np.abs(ova - ref_b["hinge_ova_sq"]) / ref_b["hinge_ova_sq"]))
    if ova.shape != (N_CLASSES,) or worst > FLOAT_RTOL:
        raise AssertionError(f"hinge one-vs-all squared: largest relative difference {worst!r} from numpy's > {FLOAT_RTOL}")
    print(f"check hinge (one-vs-all, squared) per class: largest relative difference {worst!r} (rtol {FLOAT_RTOL})")
    checks["hinge_ova_sq"] = {"worst_rel": worst}
    checks["kl"] = _check_rest_close("kl (mean)", out_k["kl"], ref_b["kl"], 0.0, KL_RTOL * ref_b["kl_scale"])
    rows = out_k["kl_log_none"].cpu().numpy().astype(np.float64)
    excess = np.abs(rows - ref_b["kl_log_rows"]) - KL_RTOL * ref_b["kl_log_scale"]
    if rows.shape != (N_SAMPLES,) or len(col_k["kl_log_none"].measures) != len(batch_slices) or excess.max() > 0:
        raise AssertionError(f"kl (log_prob, none): {rows.shape} rows, worst excess over the tolerance {excess.max()!r}")
    worst = float(np.max(np.abs(rows - ref_b["kl_log_rows"]) / ref_b["kl_log_scale"]))
    print(f"check kl (log_prob, reduction none): {N_SAMPLES:,} rows in a list state of {len(batch_slices)} entries; "
          f"largest difference {worst!r} of a row's term magnitudes (rtol {KL_RTOL})")
    checks["kl_log_none"] = {"rows": int(rows.shape[0]), "worst_rel_to_scale": worst}

    # (c) multilabel ranking on a COCO-shaped pass, without and with per-sample weights
    scores_c, target_c, weights_c = _coco_pass()
    coco_slices = [slice(i, i + BATCH) for i in range(0, N_COCO, BATCH)]
    warm = _ranking_collection(mt)
    warm.update(scores_c[:BATCH], target_c[:BATCH])
    warm.compute()
    col_c = _ranking_collection(mt)
    out_c, secs_c = _timed_pass(col_c, [(scores_c[s], target_c[s]) for s in coco_slices])
    col_cw = _ranking_collection(mt)
    out_cw, secs_cw = _timed_pass(col_cw, [(scores_c[s], target_c[s], weights_c[s]) for s in coco_slices])
    ref_c = _ranking_reference(scores_c.cpu().numpy(), target_c.cpu().numpy(), weights_c.cpu().numpy())
    for name in ("coverage", "lrap", "lrl"):
        checks[name] = _check_rest_close(name, out_c[name], ref_c[name])
        checks[f"{name} weighted"] = _check_rest_close(f"{name} weighted", out_cw[name], ref_c[f"{name} weighted"])
    if int(col_c["lrl"].total) != N_COCO or float(col_c["lrl"].weight) != N_COCO:
        raise AssertionError("the unweighted ranking states did not count every image")
    labels_per_image = float(target_c.sum()) / N_COCO

    # (d) the card against the CPU on small tricky inputs
    compared = _card_vs_cpu_rest(mt)

    # (e) timings, each metric alone at full width
    batch_p, batch_l = probs[0], labels[batch_slices[0]]
    members = {
        "ConfusionMatrix": (mt.ConfusionMatrix(num_classes=N_CLASSES, device=DEVICE), (batch_p, batch_l)),
        "JaccardIndex": (mt.JaccardIndex(num_classes=N_CLASSES, device=DEVICE), (batch_p, batch_l)),
        "MatthewsCorrCoef": (mt.MatthewsCorrCoef(num_classes=N_CLASSES, device=DEVICE), (batch_p, batch_l)),
        "CohenKappa": (mt.CohenKappa(num_classes=N_CLASSES, device=DEVICE), (batch_p, batch_l)),
        "CalibrationError": (mt.CalibrationError(n_bins=CE_BINS, device=DEVICE), (batch_p, batch_l)),
        "HingeLoss": (mt.HingeLoss(device=DEVICE), (logits[batch_slices[0]], batch_l)),
        "HingeLoss one-vs-all squared": (mt.HingeLoss(squared=True, multiclass_mode="one-vs-all", device=DEVICE),
                                         (logits[batch_slices[0]], batch_l)),
        "KLDivergence": (mt.KLDivergence(device=DEVICE), kl_inputs[0]),
        "KLDivergence log_prob none": (mt.KLDivergence(log_prob=True, reduction="none", device=DEVICE), kl_log_inputs[0]),
        "CoverageError": (mt.CoverageError(device=DEVICE), (scores_c[:BATCH], target_c[:BATCH])),
        "LabelRankingAveragePrecision": (mt.LabelRankingAveragePrecision(device=DEVICE), (scores_c[:BATCH], target_c[:BATCH])),
        "LabelRankingLoss": (mt.LabelRankingLoss(device=DEVICE), (scores_c[:BATCH], target_c[:BATCH])),
        "LabelRankingLoss weighted": (mt.LabelRankingLoss(device=DEVICE), (scores_c[:BATCH], target_c[:BATCH], weights_c[:BATCH])),
    }
    updates = _member_timings(members)
    compute_ms = {"confmat family + calibration": _timed_compute(col_a), "hinge": _timed_compute(col_h),
                  "kl": _timed_compute(col_k), "ranking": _timed_compute(col_c), "ranking weighted": _timed_compute(col_cw)}
    print(f"rest compute() ms per collection, 3 calls: {compute_ms!r}")

    launches = {route: fn.launches for route, fn in _counters(ops).items()}
    print(f"rest launches per entry point: {launches} (none of these metrics goes through the stat-scores kernel)")
    if any(launches.values()):
        raise AssertionError(f"the rest of classification launched the stat-scores kernel: {launches}")
    secs = time.perf_counter() - phase_start
    print(f"rest pass (a) samples/s: {N_SAMPLES / secs_a!r} ({secs_a!r} s, update per batch + compute of the five members)")
    print(f"rest pass (b) samples/s: hinge {N_SAMPLES / secs_h!r}, kl {N_SAMPLES / secs_k!r}")
    print(f"rest pass (c) samples/s: {N_COCO / secs_c!r} unweighted, {N_COCO / secs_cw!r} weighted "
          f"({labels_per_image!r} labels per image)")
    print(f"rest phase took {secs:.1f} s")
    line = {"classification_rest": {
        "card": card,
        "imagenet_samples_per_s": N_SAMPLES / secs_a,
        "hinge_samples_per_s": N_SAMPLES / secs_h,
        "kl_samples_per_s": N_SAMPLES / secs_k,
        "coco_samples_per_s": N_COCO / secs_c,
        "coco_weighted_samples_per_s": N_COCO / secs_cw,
        "coco_labels_per_image": labels_per_image,
        "compute_ms": compute_ms,
        "updates": updates,
        "checks": checks,
        "card_vs_cpu": compared,
        "launches": launches,
        "phase_s": secs,
    }}
    return launches, line


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
    for _ in range(PROFILER_ATTEMPTS):
        seen = _device_ops(fn, calls)
        if seen is None:
            print(f"{name}: device operations per call not checked (the profiler recorded no device activity)")
            return None
        print(f"{name}: {len(seen)} device operations in {calls} calls: {sorted({op for op, _ in seen})}")
        if len(seen) >= calls:
            break
        # a session that records fewer operations than the calls launched lost events: profile again
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
    bool_plain_ms = _device_ms(lambda: ops.fused_stat_scores_plain(*flags))[0]
    bool_own_ms = _one_launch("stat_scores bool", lambda: ops.fused_stat_scores(*flags))
    bool_bound, _ = _bound(2 * n * c + 4 * c * 4, 6 * n * c)
    print(f"stat_scores at {(n, c)} bool: kernel {bool_ms!r} ms (its own device time {bool_own_ms!r} ms), "
          f"plain {bool_plain_ms!r} ms, bound {bool_bound!r} ms")
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
        plain = lambda: ops.fused_stat_scores_logits_plain(logits, labels)  # noqa: E731
        if dtype != torch.float32:
            own_ms = _one_launch(f"stat_scores_logits {name}", kernel)
            print(f"stat_scores_logits at {(n, c)} {name} logits, int64 labels: kernel {_device_ms(kernel)[0]!r} ms "
                  f"(its own device time {own_ms!r} ms), plain {_device_ms(plain)[0]!r} ms, bound {bound_ms!r} ms")
            continue
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
    launches, single, logits, labels = phase_main_path(mt, ops)
    sync_line = phase_sync(single, logits, labels, card)
    # the kernels' own times first: torch.profiler sessions after the curve phase's lost events
    kernels = phase_timings(ops, launches, max_abs_err)
    curve_launches, curve_line = phase_curves(mt, ops, logits, labels, card)
    rest_launches, rest_line = phase_rest(mt, ops, logits, labels, card)
    del logits, labels
    print(f"launches per entry point: main path {launches}, curve phase {curve_launches}, "
          f"rest of classification {rest_launches}")
    for entry in kernels:
        route = "canonical" if entry["name"] == "stat_scores" else "logits"
        entry["launches"] += curve_launches[route] + rest_launches[route]
    print(json.dumps(sync_line))
    print(json.dumps(curve_line))
    print(json.dumps(rest_line))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--sync-rank":
        sys.exit(sync_rank(sys.argv[2], int(sys.argv[3]), Path(sys.argv[4])))
    sys.exit(main())
