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
     compute times; neither stat-scores entry point may launch;
  9. regression: (a) a dense-depth pass shaped like the NYU-Depth-v2 test split
     (654 maps of 480 x 640, batches of 8) through one ``MetricCollection`` of
     RMSE, MAE, MSLE, MAPE (AbsRel), SMAPE, WMAPE, the gamma deviance, R²,
     explained variance and Pearson; (b) a rating pass shaped like a 10 %
     hold-out of MovieLens-25M (2,500,000 half-star ratings, batches of 65,536)
     through MSE, MAE, R², Pearson and Spearman, then again with NaN
     predictions; (c) BERT-base-shaped distillation embeddings (50,000 x 768)
     through a cosine similarity, a 768-output variance-weighted R² and a
     raw explained variance; (d) CLIP-shaped pairwise products (50,000 x 512
     against 1,000 x 512, and the 1,000 x 1,000 self-similarity) through all
     four pairwise functionals, manhattan in row chunks, and the error with
     TF32 on; each against numpy float64 within a bound derived from float32
     rounding (ranks and counts bitwise); (e) pass (b) and the cosine
     similarity synced over two gloo ranks on ``cuda:0``: counts and the
     buffer metrics bitwise equal to one process, Pearson merged by
     ``_final_aggregation``, and three Pearson delta rounds equal to a twin
     that gathers in full; update, compute and call times, peak memory;
     neither stat-scores entry point may launch;
 10. wrappers and retrieval: (a) the ImageNet pass of phases 4-8 through
     ``ClasswiseWrapper(Accuracy(average=None))``, ``MinMaxMetric(Accuracy)``
     with ``forward`` per batch, ``BootStrapper(Accuracy)`` with 100 copies
     (poisson, then multinomial; each copy's counts bitwise against a twin
     generator's draws) and a ``MetricTracker`` over configuration 2 for three
     epochs (the confusion matrix has no best value), with the logits entry
     point's launches checked against what the wrappers imply; (b)
     ``MultioutputWrapper(MeanAbsoluteError, 12 outputs)`` on a QM9-shaped
     regression (130,831 x 12, 1 % of the targets NaN); (c) one
     ``MetricCollection`` of the eleven retrieval metrics on an MS MARCO
     passage dev (small)-shaped re-ranking (6,980 queries x 1,000
     candidates, batches of 64 queries), per query and on average against
     numpy (order, ranks and counts bitwise), nDCG@10 on a TREC DL
     2019-shaped graded pass, the engine on the card against the CPU path
     on tied, signed-zero and NaN scores, two card ``compute()`` calls
     bitwise equal, and the collection synced over two gloo ranks on
     ``cuda:0`` bitwise equal to one process; pass rates, update and
     compute times, device operations and copies per update, peak memory;
 11. streaming: (a) the per-pixel absolute relative error of the NYU-Depth
     pass of phase 9 (200,908,800 values, batches of 8 maps) through a
     ``StreamingQuantile`` (q 0.5, 0.9, 0.95, 0.99; capacity 2048, 18 levels)
     and a ``StreamingHistogram`` (20 bins, capacity 256), one ``kll_fold``
     launch per update, each estimate's normalized rank error within
     ``kll_rank_error_bound`` of the exact ranks (numpy on the host), the
     histogram's edges exact and its counts within the bound of
     ``np.histogram``'s; (b) the ``kll_fold`` kernel bitwise against its
     plain version, every leaf and the key included, on each sketch's
     main-path update on the last full batch (2,400 chunks of 1024 and
     19,200 of 128 folded into the deep states 80 batches left), on
     prefixes of that stream, on signed zeros, NaN, infinities and chunks
     of padding at capacities 8, 256 and 2048, on merges with empty states,
     and on a batch of 8 sketches in one launch, and the CPU's plain path
     on the prefixes;
     (c) ``WindowedMetric(Accuracy)`` (10 buckets of 5 batches) over two
     passes of the ImageNet data, each window's top-1 bitwise against numpy's
     integer counts, ``WindowedMetric(StreamingQuantile(q=0.99))`` (8 buckets)
     of the per-sample cross-entropy within the bound of each window's exact
     p99, and ``TimeDecayedMetric(MeanSquaredError, half_life=100)`` over
     the MovieLens-shaped pass against a numpy float64 EMA; (d) uneven shares
     of the NYU stream on two gloo ranks on ``cuda:0``, a sketch and a ring of
     sketches synced through the packed blob and leaf by leaf, both ranks
     bitwise equal to this process's ``kll_merge`` of the two local states;
     the fold's values/s, the kernel's own time per launch and per chunk, the
     plain version's time, update times and device operations, compactions,
     peak memory and synced bytes;
 12. multistream and checkpoint: per-class, per-source and per-user streams
     of the ImageNet and MovieLens-shaped passes through the per-stream
     entry points and ``kll_fold``, counts bitwise against numpy's, and
     checkpoints restored bitwise on the card, the CPU and two ranks;
 13. core and obs: (a) config 2 over the ImageNet pass with obs disabled,
     then enabled: the integers bitwise as phase 4's, the launches its groups
     imply, the same device operations and device->host copies per update,
     the spans and a Prometheus round trip; (b) config 2 and ``AUROC`` over
     two gloo ranks on ``cuda:0``, one async round per group leader with
     rank 1 stalled, ``sync_async()`` back within 100 ms and ``compute()``
     bitwise equal to one process's synchronous pass; (c) ``(F1Score +
     Accuracy) / 2``, ``-Precision`` and ``Accuracy(average=None)[7]`` by
     ``forward`` per batch, bitwise as their operands' ``compute()`` combined
     by hand and against the CPU path; (d) ``MeanSquaredError().half()`` over
     the NYU pass against the CPU path within one bf16 ulp, and
     ``AUROC(compute_on_cpu=True)`` beside a device-resident one (peak
     memory, update and compute times, values); (e) ``advance_windows`` over
     two windows in one compute group against the members advanced one by
     one; (f) small reruns of phases 11 and 12 with obs enabled: their
     counters reach ``summarize_counters()`` and an update's copies do not
     change; and the large-S branch of the canonical per-stream entry point
     against its plain version;
 14. detection and image: (a) a COCO val2017-shaped bbox pass (5,000 images of
     640 x 480, 80 classes, 36,781 gts with a heavy tail per image, 100
     detections an image on the card, batches of 16) through
     ``MeanAveragePrecision`` on its device route (the ``coco_match`` kernel)
     and its C++ host route: recall bitwise, precision values within 1e-6,
     images/s and each route's ``last_compute_profile``; (b) the same shapes
     with masks as COCO RLE strings over 500 of the images (the strings are
     encoded on the host in setup); (c) ``dist_sync_on_step=True`` over two
     gloo ranks on ``cuda:0`` for 500 images, each step's value bitwise one
     process's over both ranks' images, the epoch's served by the IoU cache;
     (d) the ``coco_match`` kernel bitwise against its plain version on (a)'s
     and (b)'s operands and planted ties, its time, launches and bound; (e)
     a DIV2K validation-shaped super-resolution pass (100 RGB images of 1356 x
     2040, batches of 4) through PSNR, SSIM, MS-SSIM and UQI, and a 4-band
     pan-sharpening pass (1,000 patches of 256 x 256, batches of 32) through
     ERGAS, SAM and D-lambda, the card within tolerance of the CPU with TF32
     allowed and not, and pixels/s.  It fails if the C++ host library did
     not build;
 15. generation, LPIPS and text (no kernel of the port lies on this path: the
     JAX package runs these metrics without Pallas): (a) 10,000 real and
     10,000 generated CIFAR-10 test-shaped images (3 x 32 x 32 uint8, made on
     the card from the seed, batches of 100) through FID (2048 features),
     KID (100 subsets of 1,000) and IS (10 splits over the unbiased logits of
     the generated set) on the built-in Inception-v3 (random init from the
     seed, FID variant, resized to 299), each at the caller's batch and with
     ``extractor_batch=500``, equal within tolerance, and FID once more in
     bfloat16; one batch's features on the card against the CPU's, and FID
     from the same states on the CPU; images/s, the extractor's ms per image
     and FID's ``compute()`` ms; (b) 5,000 BAPPS-shaped 64 x 64 patch pairs
     (batches of 50) through LPIPS on ``alex``, ``vgg`` and ``squeeze``, the
     card against the CPU, pairs/s; (c) FID and KID over two gloo ranks on
     ``cuda:0``, each rank half of (a), equal to (a)'s one process, and the
     bytes KID's cat states gather; (d) 2,620 LibriSpeech test-clean-shaped
     utterance pairs (seeded words, about 5 % substitutions, insertions and
     deletions) through WER, CER, MER, WIL and WIP in one collection (batches
     of 32): the card's values bitwise the CPU's, WER as a plain edit
     distance gives it, the updates issue no device operation (profiler),
     utterances/s;
 16. the rest of text and audio (no kernel of the port lies on this path
     either): (a) a WMT newstest-shaped corpus (3,000 segments of 15-40 Zipf
     words, one reference, batches of 100) through BLEU, SacreBLEU (13a),
     chrF++, TER and EED, each timed alone; (b) 11,490 CNN/DailyMail-shaped
     summary pairs (about 56 words in 3-4 newline-separated sentences)
     through ROUGE-1/2/L/Lsum and 10,570 SQuAD v1.1 dev-shaped questions
     (1-3 answers) through SQuAD; the states of (a) and (b) bitwise those of
     a CPU twin that runs meanwhile as a process of its own (``chip_smoke.py
     --text-cpu-twin DIR``), and their updates issue no device operation
     (profiler, taken early); (c) BERTScore on an encoder of roberta-large's
     shape (24 layers, hidden 1024, 16 heads, FFN 4096, vocabulary 50,265;
     random weights from the seed) with the ported WordPiece tokenizer built
     from the corpus, ``num_layers=17``, ``max_length=128``,
     ``batch_size=64`` over 1,000 of (a)'s pairs, then ``idf=True`` and
     ``all_layers=True`` on 64 pairs; the card against the CPU port on 16
     pairs and the matching alone on identical embeddings; pairs/s and
     ``last_compute_breakdown``; (d) 3,000 WSJ0-2mix-shaped pairs (8 kHz,
     4 s, batches of 16) through SNR, SI-SNR, SI-SDR and SDR (512 taps), the
     card against the CPU port and SDR against a float64 solve; PIT with
     SI-SDR over 2- and 3-speaker mixtures (exhaustive on the card) and
     8-speaker ones (the host LAP), every mixture unscrambled; the PESQ and
     STOI gates raise;
 17. the serve tier: one ``EvalServer`` on the card (``block_rows=1024``)
     with four jobs fed over localhost HTTP: ``top1`` (``Accuracy``) and
     ``per_class`` (a 1,000-stream ``MultiStreamMetric`` of a micro
     ``Accuracy``, an out-of-range id on every 13th row) get phase 4's
     ImageNet pass through ``POST /ingest_columns`` in bodies of 1,024 rows,
     ``latency`` (``StreamingQuantile``, q 0.5 and 0.99, capacity 2048)
     1,048,576 log-normal latencies in bodies of 65,536, ``mse`` 4,096 JSON
     records in 8 ``POST /ingest``.  (a) After the flush each job's state is
     bitwise a twin's updated directly with the pieces its batcher
     dispatched (52 for top1, 49 padded blocks for per_class), the counts
     against numpy, and each entry point's launches what the pieces imply;
     (b) a reader thread queries every endpoint while ingest runs (p50/p99
     ms), and after the flush every answer is the twin's values widened to
     float64, bit for bit; (c) the durability drill: every body framed into
     a WAL before its ``seqs=`` POST, a checkpoint after 25 bodies, a kill
     after 40, a new server restored and fed the frames past the
     checkpoint's watermarks (one of them twice, deduped), bitwise the
     uninterrupted run; three frames byte for byte the documented layout;
     (d) the card's checkpoint restored into a registry on the CPU, bitwise.
     Records/s per job end to end, query p50/p99, checkpoint and restore
     ms, and the device operations and host copies of one block dispatch
     (profiled early in ``main``);
 18. the serve fleet: (a) four in-process shards on the card (``LocalFleet``,
     ``block_rows=4096``, interval flushing off, a WAL and checkpoints):
     ``per_user`` (a ``MeanSquaredError`` over MovieLens-25M's 162,541 users)
     and ``latency`` (a ``StreamingQuantile`` of the absolute errors) take phase
     9's 2,500,000 ratings (predictions rounded to eighths) with phase 12's
     Zipf user ids through ``run_load``, and a second fleet of int32 rows
     ``per_class`` (a 1,000-stream ``Accuracy``) the ImageNet pass's argmax
     predictions; a reader queries the frontend's ``top_k``, ``where`` and
     ``compute_streams`` meanwhile; then ``checkpoint_all``, a kill of the
     shard holding ``latency``, more rows (the victim's park), ``failover``
     with WAL replay, ``resize(3)`` and the rest of the rows.  After each stage
     every job's ``compute_all()`` is bitwise a one-shard twin's fed the same
     rows; ``per_user`` and ``per_class`` bitwise numpy's float64 values
     rounded once, ``latency`` within the KLL rank-error bound; the
     per-stream canonical and ``kll_fold`` launches are the dispatched blocks.
     (b) Two ``python -m metrics_tpu_torch.serve.worker --device cuda``
     processes behind an ``HTTPShard`` coordinator with a WAL: SIGKILL one,
     rows park, failover to a new process, bitwise an in-process twin; then
     two process-mode load children through the frontend.  (c) The soak drill
     (``soak.run_drill`` at its defaults) on the card, bit-identical.
     Records/s per job, query p50/p99, checkpoint, failover and resize ms,
     replay rows/s, READY ms per worker, the process load's records/s;
  19. mesh placement (``phase_mesh``): (a) a one-rank mesh on ``cuda:0`` over
     NCCL: configuration 2 over the ImageNet pass through
     ``MetricCollection.shard(default_mesh())``, bitwise the unplaced
     collection, every leaf a ``Partial`` DTensor, the logits entry point
     launched as often as unplaced and held against its plain version, the
     sync reports' ``in_xla_reductions`` and zero bytes, ms per update placed
     against unplaced in turns; phase 12 (a)'s per-class accuracy (1,000
     streams) through ``shard_streams``, bitwise.  (b) Two gloo ranks on the
     card (``--sync-rank mesh``): each rank's half of the JAX package's
     configuration 10 (``Accuracy`` over the ImageNet rows and
     ``MeanAveragePrecision(on_device=True)`` over phase 14's COCO-shaped
     images, 8 updates between syncs) and a ``StreamingQuantile`` of phase
     9's per-pixel errors, all placed on a mesh of the two ranks: accuracy
     bitwise one process's, the merged sketch bitwise the rank-order
     ``kll_merge`` through the kernel and through its plain version, mAP
     within ``MAP_VALUE_TOL`` of one process's and bitwise its own compute
     with ``coco_match``'s plain version; configuration 2 synced through
     ``MeshBackend`` (its reduced states combined, and one collective a
     state) and ``DistBackend`` on the same states (ms in turns, bytes
     through the host);
  20. the public utilities (``phase_utils``): (a)
     ``check_forward_full_state_property(Accuracy)`` on the first ImageNet
     batch of phases 4-8 on the card (10 and 100 steps, 2 repetitions): the
     two forward paths agree, its printed timings, and the logits entry
     point launched as often as the forwards imply; (b) ``to_categorical``
     (ties, NaN, each axis), ``class_reduce`` (all four reductions over the
     pass's per-class counts, one class with a zero denominator),
     ``apply_to_collection`` and ``get_group_indexes`` (an MS MARCO-shaped
     id column) on CUDA tensors against the same calls on CPU tensors:
     integers and indexes bitwise, quotients bitwise, float32 sums of 1,000
     terms within their rounding bound, every result on the card.
The last line is ``{"ok": true, "device": {...}}``.

The sync phases run this script again as their ranks
(``chip_smoke.py --sync-rank SCENARIO RANK DIR``); the parent waits on them
with a time limit and fails if a rank fails or hangs.
"""

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import warnings
from datetime import timedelta
from functools import lru_cache
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
FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores, the same sheet
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
    from metrics_tpu_torch import _native
    from metrics_tpu_torch.ops import _build, coco_match, kll

    start = time.perf_counter()
    host = threading.Thread(target=_native.get_lib)  # g++ of the host library beside the nvccs
    host.start()
    built = _build.build(ops._SOURCE, kll._SOURCE, coco_match._SOURCE)  # one nvcc per source, all started together
    ops._library()
    kll._library()
    coco_match._library()
    host.join()
    if not _native.native_available():
        raise AssertionError(f"the C++ host library did not build from {_native.SOURCE.relative_to(ROOT)}")
    print(f"build: host library {_native.library_path().relative_to(ROOT)}")
    print(f"build: {[str(path.relative_to(ROOT)) for path, _ in built]} in {time.perf_counter() - start:.3f} s")
    for _, log in built:
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
    if scenario == "regression":
        _rank_regression(mt, rank, where)
    elif scenario == "retrieval":
        _rank_retrieval(mt, rank, where)
    elif scenario == "streaming":
        _rank_streaming(mt, rank, where)
    elif scenario == "checkpoint":
        _rank_checkpoint(mt, rank, where)
    elif scenario == "detection":
        _rank_detection(mt, rank, where)
    elif scenario == "generation":
        _rank_generation(mt, rank, where)
    elif scenario == "mesh":
        _rank_mesh(mt, ops, rank, where)
    else:
        _, _, batches = _imagenet_pass()
        if scenario == "stall":
            _rank_stall(mt, rank, batches, where, store)
        {"main": lambda: _rank_main(mt, ops, rank, batches, where),
         "desync": lambda: _rank_desync(mt, rank, batches, where),
         "curves": lambda: _rank_curves(mt, ops, rank, batches, where),
         "async": lambda: _rank_async(mt, ops, rank, batches, where)}[scenario]()
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


# ---------------------------------------------------------------- regression
U32 = 2.0**-24  # float32 unit roundoff
NYU_MAPS, NYU_H, NYU_W, NYU_BATCH = 654, 480, 640, 8  # NYU-Depth-v2 test split: 654 depth maps of 480 x 640
ML_RATINGS, ML_BATCH, ML_NANS = 2_500_000, 65_536, 7  # a 10 % hold-out of MovieLens-25M
# MovieLens-25M's share of each half-star rating, 0.5 to 5.0 (skewed toward 3.5-4.0)
ML_SHARES = (0.016, 0.031, 0.016, 0.066, 0.050, 0.196, 0.126, 0.266, 0.086, 0.147)
DISTIL_N, DISTIL_D, DISTIL_BATCH = 50_000, 768, 1024  # BERT-base student and teacher embeddings
CLIP_N, CLIP_CLASSES, CLIP_D = 50_000, 1000, 512  # CLIP ViT-B/32 zero-shot on ImageNet: images x class prompts
MANHATTAN_SAMPLE = 1000  # rows of the manhattan matrix checked against float64
REG_SYNC_SHARDS = ((0, 20), (20, None))  # MovieLens batch ranges of the two ranks: 20 and 19 batches
DISTIL_SYNC_SHARDS = ((0, 25), (25, None))  # distillation batch ranges of the two ranks: 25 and 24 batches
# The depth of a float32 sum, in additions on one chain, bounds its rounding: |error| <= depth x U x
# sum |terms|.  A reduction of n terms has a chain of at most n - 1 in any order.  Over millions of
# terms the card's chain is far shorter: PyTorch's CUDA reduction (ATen Reduce.cuh) gives a thread
# at most 256 values (max_values_per_thread), and warps, blocks and blocks of blocks add at most
# 64 levels above that.  A stream of batches adds one addition per batch.
SUM_DEPTH = 256 + 64


def _propagated(f, sums: dict, errs: dict):
    """First-order bound on |f(the float32 sums) - f(the exact sums)|, f applied elementwise: each
    sum moved by its own bound in turn, float64."""
    base = f(**sums)
    return sum(np.abs(f(**{**sums, k: sums[k] + errs[k]}) - base) for k in sums)


def _check_bound(name: str, got, want, bound, checks: dict, phase: str = "regression") -> None:
    """|got - want| <= bound elementwise (float64 reference, derived bound); records the worst ratio."""
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got, dtype=np.float64)
    diff = np.abs(got - want)
    ratio = float(np.max(diff / np.maximum(bound, 1e-300))) if diff.size else 0.0
    if not np.all(np.isfinite(got)) or not np.all(diff <= bound):
        raise AssertionError(f"{name}: {got.ravel()[:4]!r} against numpy float64 {np.ravel(want)[:4]!r}, "
                             f"bound {np.ravel(bound)[:4]!r}, worst ratio {ratio!r}")
    shown = float(got) if got.size == 1 else f"{got.size} values"
    print(f"check {phase} {name}: {shown!r} (numpy float64 {float(np.ravel(want)[0]) if np.size(want) == 1 else '...'!r}), "
          f"largest difference {float(diff.max())!r} = {ratio:.3g} of its float32 bound")
    checks[name] = {"value": got.tolist() if got.size == 1 else None, "worst_share_of_bound": ratio}


def _regression_collection_a(mt):
    return mt.MetricCollection({
        "rmse": mt.MeanSquaredError(squared=False, device=DEVICE),
        "mae": mt.MeanAbsoluteError(device=DEVICE),
        "msle": mt.MeanSquaredLogError(device=DEVICE),
        "absrel": mt.MeanAbsolutePercentageError(device=DEVICE),
        "smape": mt.SymmetricMeanAbsolutePercentageError(device=DEVICE),
        "wmape": mt.WeightedMeanAbsolutePercentageError(device=DEVICE),
        "gamma_deviance": mt.TweedieDevianceScore(power=2, device=DEVICE),
        "r2": mt.R2Score(device=DEVICE),
        "explained_variance": mt.ExplainedVariance(device=DEVICE),
        "pearson": mt.PearsonCorrCoef(device=DEVICE),
    }, device=DEVICE)


def _regression_collection_b(mt, **kwargs):
    return mt.MetricCollection({
        "mse": mt.MeanSquaredError(device=DEVICE, **kwargs),
        "mae": mt.MeanAbsoluteError(device=DEVICE, **kwargs),
        "r2": mt.R2Score(device=DEVICE, **kwargs),
        "pearson": mt.PearsonCorrCoef(device=DEVICE, **kwargs),
        "spearman": mt.SpearmanCorrCoef(device=DEVICE, **kwargs),
    }, device=DEVICE)


def _nyu_pass() -> list:
    """654 depth maps in metres (0.5-10.0) and predictions target x exp(eps), eps ~ N(0, 0.1^2),
    made on the card from the seed, as batches of 8 flattened maps (the last of 6)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    n, per = NYU_MAPS * NYU_H * NYU_W, NYU_BATCH * NYU_H * NYU_W
    target = torch.rand(n, generator=gen, device=DEVICE).mul_(10.0 - 0.5).add_(0.5)
    preds = torch.randn(n, generator=gen, device=DEVICE).mul_(0.1).exp_().mul_(target)
    return [(preds[i : i + per], target[i : i + per]) for i in range(0, n, per)]


def _movielens_pass() -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Half-star ratings with MovieLens-25M's shares, predictions target + N(0, 0.8^2) clipped to
    [0.5, 5.0], and the positions of the NaN predictions of the second pass, all from the seed."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    shares = torch.tensor(ML_SHARES, device=DEVICE, dtype=torch.float64)
    target = (torch.multinomial(shares, ML_RATINGS, replacement=True, generator=gen) + 1).to(torch.float32) * 0.5
    preds = (target + 0.8 * torch.randn(ML_RATINGS, generator=gen, device=DEVICE)).clamp_(0.5, 5.0)
    nan_at = torch.randperm(ML_RATINGS, generator=gen, device=DEVICE)[:ML_NANS]
    return preds, target, nan_at


def _distil_pass() -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher embeddings with a scale per dimension, and a student's: teacher + N(0, 0.5^2) noise."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    scale = torch.randn(DISTIL_D, generator=gen, device=DEVICE).mul_(0.5).exp_()
    teacher = torch.randn(DISTIL_N, DISTIL_D, generator=gen, device=DEVICE) * scale
    student = teacher + 0.5 * torch.randn(DISTIL_N, DISTIL_D, generator=gen, device=DEVICE)
    return student, teacher


def _batched(preds: torch.Tensor, target: torch.Tensor, size: int) -> list:
    return [(preds[i : i + size], target[i : i + size]) for i in range(0, preds.shape[0], size)]


def _stream_moments(batches) -> dict:
    """Everything pass (a)'s references and bounds need, summed batch by batch in numpy float64."""
    acc: dict = {}
    for preds, target in batches:
        p = preds.cpu().numpy().astype(np.float64)
        t = target.cpu().numpy().astype(np.float64)
        d = t - p
        ad = np.abs(d)
        lp, lt = np.log1p(p), np.log1p(t)
        ld = lp - lt
        ratio = t / p
        dev = 2 * (np.log(p / t) + ratio - 1)
        terms = dict(
            n=float(t.size), sd=d.sum(), sd2=d @ d, sad=ad.sum(), st=t.sum(), st2=t @ t, sp=p.sum(), sp2=p @ p, spt=p @ t,
            sld2=ld @ ld, ape=(ad / t).sum(), sape=(2 * ad / (t + p)).sum(), dev=dev.sum(),
            # the rounding each term brings before it is summed, where its operations cancel
            msle_terms=(2 * np.abs(ld) * (2 * (lp + lt) + np.abs(ld)) + ld * ld).sum(),
            dev_terms=(2 * (1 + 2 * np.abs(np.log(p / t)) + ratio + np.abs(ratio - 1) + np.abs(dev) / 2)).sum(),
        )
        for key, value in terms.items():
            acc[key] = acc.get(key, 0.0) + value
    return acc


def _pearson_reference(m: dict, depth: float) -> Tuple[float, float]:
    """Pearson's float64 value from the moments, and the bound on its float32 streaming value: its
    variances and covariance are sums of products of centred terms (<= depth x U of their magnitude,
    by Cauchy-Schwarz at most sqrt(vx vy) for the covariance), off by what the running means carry."""
    n = m["n"]
    vx, vy = m["sp2"] - m["sp"] ** 2 / n, m["st2"] - m["st"] ** 2 / n
    cov = m["spt"] - m["sp"] * m["st"] / n
    e_mx, e_my = (depth + 4) * U32 * abs(m["sp"]) / n, (depth + 4) * U32 * abs(m["st"]) / n
    errs = {
        "vx": depth * U32 * vx + 2 * e_mx * np.sqrt(n * vx),
        "vy": depth * U32 * vy + 2 * e_my * np.sqrt(n * vy),
        "cov": depth * U32 * np.sqrt(vx * vy) + e_mx * np.sqrt(n * vy) + e_my * np.sqrt(n * vx),
    }
    f = lambda vx, vy, cov: cov / np.sqrt(vx * vy)  # noqa: E731
    value = f(vx, vy, cov)
    return value, _propagated(f, {"vx": vx, "vy": vy, "cov": cov}, errs) + 8 * U32 * abs(value)


def _r2_reference(st2, st, rss, n, depth: float, st_abs=None, final_units: float = 8):
    """R² = 1 - rss / (st2 - st^2 / n) in float64 and its float32 bound (elementwise over outputs)."""
    st_abs = np.abs(st) if st_abs is None else st_abs
    f = lambda st2, st, rss: 1 - rss / (st2 - st * (st / n))  # noqa: E731
    sums = {"st2": st2, "st": st, "rss": rss}
    errs = {"st2": (depth + 1) * U32 * st2, "st": depth * U32 * st_abs, "rss": (depth + 2) * U32 * rss}
    value = f(**sums)
    return value, _propagated(f, sums, errs) + final_units * U32 * np.abs(value)


def _ev_reference(sd, sd2, st, st2, n, depth: float, sad, st_abs):
    """Explained variance 1 - var(error) / var(target) in float64 and its float32 bound (elementwise)."""
    def f(sd, sd2, st, st2):
        return 1 - (sd2 / n - (sd / n) ** 2) / (st2 / n - (st / n) ** 2)

    sums = {"sd": sd, "sd2": sd2, "st": st, "st2": st2}
    errs = {"sd": (depth + 1) * U32 * sad, "sd2": (depth + 2) * U32 * sd2, "st": depth * U32 * st_abs, "st2": (depth + 1) * U32 * st2}
    value = f(**sums)
    return value, _propagated(f, sums, errs) + 8 * U32 * np.abs(value)


def _spearman_reference(ranks_p: np.ndarray, ranks_t: np.ndarray, depth: float) -> Tuple[float, float]:
    """Spearman from exact float64 ranks, and the float32 bound of the port's value: its rank means
    are sums of n ranks, its covariance and variances sums of n centred products."""
    n = float(ranks_p.size)
    pd, td = ranks_p - ranks_p.mean(), ranks_t - ranks_t.mean()
    c, vp, vt = pd @ td, pd @ pd, td @ td
    e_mp, e_mt = (depth + 1) * U32 * ranks_p.mean(), (depth + 1) * U32 * ranks_t.mean()
    errs = {"c": depth * U32 * np.sqrt(vp * vt) + e_mp * np.sqrt(n * vt) + e_mt * np.sqrt(n * vp),
            "vp": depth * U32 * vp + 2 * e_mp * np.sqrt(n * vp), "vt": depth * U32 * vt + 2 * e_mt * np.sqrt(n * vt)}
    f = lambda c, vp, vt: (c / n) / (np.sqrt(vp / n) * np.sqrt(vt / n) + 1e-6)  # noqa: E731
    value = f(c, vp, vt)
    return value, _propagated(f, {"c": c, "vp": vp, "vt": vt}, errs) + 8 * U32 * abs(value)


def _average_ranks(x: np.ndarray) -> np.ndarray:
    """scipy's average ranks with NaN last and tied (the order jnp gives); x holds no infinity."""
    from scipy.stats import rankdata

    if np.isinf(x).any():
        raise AssertionError("the reference ranks stand NaN in for +inf: the scores must hold no infinity")
    return rankdata(np.where(np.isnan(x), np.inf, x), method="average")


def _pairwise_reference(name: str, x: np.ndarray, y: np.ndarray, zero_diagonal: bool) -> Tuple[np.ndarray, np.ndarray]:
    """A pairwise matrix in float64 and the bound on its float32 entries, for any order of the
    d-term sums: a dot product <= d U sum |x_k y_k|; a euclidean distance, whose Gram form cancels,
    <= sqrt((d + 3) U (|x|² + |y|² + 2 sum |x_k y_k|)) + U d; unit rows' dot product <= (2d + 8) U."""
    d = x.shape[1]
    if name == "linear":
        value, bound = x @ y.T, d * U32 * (np.abs(x) @ np.abs(y).T)
    elif name == "cosine":
        xu = x / np.linalg.norm(x, axis=1, keepdims=True)
        yu = y / np.linalg.norm(y, axis=1, keepdims=True)
        value = xu @ yu.T
        bound = np.full(value.shape, (2 * d + 8) * U32)
    else:
        xn, yn = (x * x).sum(1)[:, None], (y * y).sum(1)[None, :]
        value = np.sqrt(np.maximum(xn + yn - 2 * (x @ y.T), 0.0))
        bound = np.sqrt((d + 3) * U32 * (xn + yn + 2 * (np.abs(x) @ np.abs(y).T))) + U32 * value
    if zero_diagonal:
        np.fill_diagonal(value, 0.0)
        np.fill_diagonal(bound, 0.0)
    return value, bound


def _peak_bytes(fn) -> Tuple[object, int]:
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def _regression_pass(col, batches) -> Tuple[dict, float, int]:
    """One update per batch and the final compute: results, samples per second, peak device bytes."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, secs = _timed_pass(col, batches)
    samples = sum(b[0].shape[0] for b in batches)
    return out, samples / secs, torch.cuda.max_memory_allocated()


def phase_regression(mt, ops, card: str) -> Tuple[dict, dict]:
    """Regression and the pairwise functionals at full width: (a) NYU-Depth-v2-shaped dense depth,
    (b) a MovieLens-25M-shaped rating hold-out, then with NaN predictions, (c) BERT-base-shaped
    multi-output distillation, (d) CLIP-shaped pairwise products, (e) pass (b) synced over two
    ranks; each against numpy float64 within a bound derived from float32 rounding."""
    from metrics_tpu_torch.functional.pairwise.manhattan import _CHUNK_ELEMENTS
    from metrics_tpu_torch.functional.regression.spearman import _rank_data

    phase_start = time.perf_counter()
    for fn in _counters(ops).values():
        fn.launches = 0
    checks, passes = {}, {}

    # (a) dense depth prediction, NYU-Depth-v2-shaped
    batches_a = _nyu_pass()
    warm = _regression_collection_a(mt)
    warm.update(*batches_a[0])
    warm.compute()
    col_a = _regression_collection_a(mt)
    out_a, rate_a, peak_a = _regression_pass(col_a, batches_a)
    m = _stream_moments(batches_a)
    depth_a = SUM_DEPTH + len(batches_a)
    n = m["n"]
    if int(col_a["rmse"].total) != n or float(col_a["explained_variance"].n_obs) != n:
        raise AssertionError(f"pass (a) counted {int(col_a['rmse'].total)} pixels, not {int(n)}")
    refs_a = {
        # name: (float64 value, bound of the float32 value)
        "rmse": (np.sqrt(m["sd2"] / n), (depth_a + 4) * U32 * np.sqrt(m["sd2"] / n)),
        "mae": (m["sad"] / n, (depth_a + 3) * U32 * m["sad"] / n),
        "msle": (m["sld2"] / n, ((depth_a + 1) * m["sld2"] + m["msle_terms"]) * U32 / n),
        "absrel": (m["ape"] / n, (depth_a + 5) * U32 * m["ape"] / n),
        "smape": (m["sape"] / n, (depth_a + 7) * U32 * m["sape"] / n),
        "wmape": (m["sad"] / m["st"], (2 * depth_a + 5) * U32 * m["sad"] / m["st"]),
        "gamma_deviance": (m["dev"] / n, (depth_a * m["dev"] + m["dev_terms"]) * U32 / n),
        "r2": _r2_reference(m["st2"], m["st"], m["sd2"], n, depth_a),
        "explained_variance": _ev_reference(m["sd"], m["sd2"], m["st"], m["st2"], n, depth_a, m["sad"], m["st"]),
        "pearson": _pearson_reference(m, depth_a),
    }
    for name, (want, bound) in refs_a.items():
        _check_bound(f"(a) {name}", out_a[name], want, bound, checks)

    # (b) rating regression, MovieLens-25M-shaped; then the same pass with NaN predictions
    preds_b, target_b, nan_at = _movielens_pass()
    batches_b = _batched(preds_b, target_b, ML_BATCH)
    warm = _regression_collection_b(mt)
    warm.update(*batches_b[0])
    warm.compute()
    col_b = _regression_collection_b(mt)
    out_b, rate_b, peak_b = _regression_pass(col_b, batches_b)
    p_host, t_host = preds_b.cpu().numpy().astype(np.float64), target_b.cpu().numpy().astype(np.float64)
    mb = {"n": float(p_host.size), "sp": p_host.sum(), "st": t_host.sum(), "sp2": p_host @ p_host,
          "st2": t_host @ t_host, "spt": p_host @ t_host}
    d_host = t_host - p_host
    depth_b = SUM_DEPTH + len(batches_b)
    nb = mb["n"]
    refs_b = {
        "mse": (d_host @ d_host / nb, (depth_b + 3) * U32 * (d_host @ d_host) / nb),
        "mae": (np.abs(d_host).sum() / nb, (depth_b + 3) * U32 * np.abs(d_host).sum() / nb),
        "r2": _r2_reference(mb["st2"], mb["st"], d_host @ d_host, nb, depth_b),
        "pearson": _pearson_reference(mb, depth_b),
    }
    ranks_p, ranks_t = _average_ranks(p_host.astype(np.float32)), _average_ranks(t_host.astype(np.float32))
    refs_b["spearman"] = _spearman_reference(ranks_p, ranks_t, SUM_DEPTH)
    for name, (want, bound) in refs_b.items():
        _check_bound(f"(b) {name}", out_b[name], want, bound, checks)
    if col_b["mse"].total.dtype != torch.int32 or int(col_b["mse"].total) != ML_RATINGS:
        raise AssertionError(f"pass (b): MSE counted {col_b['mse'].total!r}, not int32 {ML_RATINGS}")
    card_ranks = _rank_data(col_b["spearman"].buffer_values("target"))
    if not np.array_equal(card_ranks.cpu().numpy(), ranks_t.astype(np.float32)):
        raise AssertionError("pass (b): the card's ranks of the tied ratings differ from scipy's average ranks")
    tie_groups = int(np.unique(t_host).size)
    print(f"check regression (b) ranks: {ML_RATINGS:,} ratings in {tie_groups} tie groups, the card's average ranks "
          "bitwise equal to scipy's")

    preds_nan = preds_b.clone()
    preds_nan[nan_at] = float("nan")
    col_nan = _regression_collection_b(mt)
    out_nan, rate_nan, _ = _regression_pass(col_nan, _batched(preds_nan, target_b, ML_BATCH))
    nan_host = preds_nan.cpu().numpy()
    card_ranks = _rank_data(col_nan["spearman"].buffer_values("preds"))
    cpu_ranks = _rank_data(col_nan["spearman"].buffer_values("preds").cpu())
    ranks_nan = _average_ranks(nan_host)
    if not (torch.equal(card_ranks.cpu(), cpu_ranks) and np.array_equal(cpu_ranks.numpy(), ranks_nan.astype(np.float32))):
        raise AssertionError("pass (b) with NaN: the card's ranks differ from the CPU path's or scipy's (NaN last)")
    want, bound = _spearman_reference(ranks_nan, ranks_t, SUM_DEPTH)
    _check_bound("(b NaN) spearman", out_nan["spearman"], want, bound, checks)
    cpu_value = mt.functional.spearman_corrcoef(preds_nan.cpu(), target_b.cpu())
    _check_bound("(b NaN) spearman, card against the CPU path", out_nan["spearman"], float(cpu_value), 2 * bound, checks)
    for name in ("mse", "mae", "r2", "pearson"):
        if not torch.isnan(out_nan[name]):
            raise AssertionError(f"pass (b) with NaN: {name} is {out_nan[name]!r}, not NaN as numpy gives")
    print(f"check regression (b NaN): {ML_NANS} NaN predictions rank last and tied; the card's ranks bitwise equal "
          "to the CPU path's and scipy's; mse, mae, r2 and pearson are NaN as in numpy")

    # (c) multi-output distillation, BERT-base-shaped
    student, teacher = _distil_pass()
    batches_c = _batched(student, teacher, DISTIL_BATCH)
    members_c = lambda: {  # noqa: E731
        "cosine": mt.CosineSimilarity(reduction="mean", device=DEVICE),
        "r2": mt.R2Score(num_outputs=DISTIL_D, multioutput="variance_weighted", device=DEVICE),
        "explained_variance": mt.ExplainedVariance(multioutput="raw_values", device=DEVICE),
    }
    warm = mt.MetricCollection(members_c(), device=DEVICE)
    warm.update(*batches_c[0])
    warm.compute()
    col_c = mt.MetricCollection(members_c(), device=DEVICE)
    out_c, rate_c, peak_c = _regression_pass(col_c, batches_c)
    s_host, t_host = student.cpu().numpy().astype(np.float64), teacher.cpu().numpy().astype(np.float64)
    dot, sn, tn = (s_host * t_host).sum(1), np.linalg.norm(s_host, axis=1), np.linalg.norm(t_host, axis=1)
    sims = dot / (sn * tn)
    row_depth = DISTIL_D + 8  # a row's dot product and norms: DISTIL_D terms each, then the quotient
    e_rows = row_depth * U32 * ((np.abs(s_host) * np.abs(t_host)).sum(1) / (sn * tn) + 2 * np.abs(sims))
    _check_bound("(c) cosine (mean)", out_c["cosine"], sims.mean(),
                 e_rows.mean() + (SUM_DEPTH + 2) * U32 * np.abs(sims).mean(), checks)
    depth_c = DISTIL_BATCH + len(batches_c)  # column sums of a batch, then one addition per batch
    d_c = t_host - s_host
    st, st2, rss = t_host.sum(0), (t_host * t_host).sum(0), (d_c * d_c).sum(0)
    st_abs = np.abs(t_host).sum(0)
    tss = st2 - st * st / DISTIL_N
    e_tss = (depth_c + 3) * U32 * st2 + 2 * np.abs(st) / DISTIL_N * depth_c * U32 * st_abs
    e_rss = (depth_c + 2) * U32 * rss
    want = 1 - rss.sum() / tss.sum()  # variance-weighted R² = sum(tss / sum(tss) x (1 - rss / tss)) = 1 - sum(rss) / sum(tss)
    # ... which the port sums over the outputs as 768 weighted scores, a few roundings each
    weighted = np.abs(tss / tss.sum() * (1 - rss / tss)).sum()
    bound = (e_rss.sum() + rss.sum() / tss.sum() * e_tss.sum()) / tss.sum() + (DISTIL_D + 8) * U32 * weighted
    _check_bound("(c) r2 (768 outputs, variance-weighted)", out_c["r2"], want, bound, checks)
    want, bound = _ev_reference(d_c.sum(0), rss, st, st2, float(DISTIL_N), depth_c, np.abs(d_c).sum(0), st_abs)
    if tuple(out_c["explained_variance"].shape) != (DISTIL_D,):
        raise AssertionError(f"(c) explained variance raw_values has shape {tuple(out_c['explained_variance'].shape)}")
    _check_bound("(c) explained variance (raw, 768 outputs)", out_c["explained_variance"], want, bound, checks)

    # (d) pairwise, CLIP ViT-B/32 zero-shot-shaped
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    images = torch.randn(CLIP_N, CLIP_D, generator=gen, device=DEVICE)
    classes = torch.randn(CLIP_CLASSES, CLIP_D, generator=gen, device=DEVICE)
    img_host, cls_host = images.cpu().numpy().astype(np.float64), classes.cpu().numpy().astype(np.float64)
    f = mt.functional
    calls = {"linear": f.pairwise_linear_similarity, "cosine": f.pairwise_cosine_similarity,
             "euclidean": f.pairwise_euclidean_distance}
    pairwise_ms, pairwise_refs = {}, {}
    for name, fn in calls.items():
        want, bound = _pairwise_reference(name, img_host, cls_host, False)
        pairwise_refs[name] = want
        got = fn(images, classes)
        _check_bound(f"(d) pairwise {name} {CLIP_N}x{CLIP_CLASSES}", got, want, bound, checks)
        mean = fn(images, classes, reduction="mean")
        _check_bound(f"(d) pairwise {name} {CLIP_N}x{CLIP_CLASSES} mean", mean, want.mean(1),
                     bound.mean(1) + (CLIP_CLASSES + 1) * U32 * np.abs(want).mean(1), checks)
        want, bound = _pairwise_reference(name, cls_host, cls_host, True)
        _check_bound(f"(d) pairwise {name} {CLIP_CLASSES}x{CLIP_CLASSES} self, zero diagonal", fn(classes), want, bound, checks)
        pairwise_ms[name] = _call_ms(lambda: fn(images, classes), reps=5, warmup=1)
        pairwise_ms[f"{name} mean"] = _call_ms(lambda: fn(images, classes, reduction="mean"), reps=5, warmup=1)
        del got, mean
    manhattan, manhattan_peak = _peak_bytes(lambda: f.pairwise_manhattan_distance(images, classes))
    rows = np.sort(np.random.default_rng(SEED + 12).choice(CLIP_N, MANHATTAN_SAMPLE, replace=False))
    from scipy.spatial.distance import cdist

    want = cdist(img_host[rows], cls_host, "cityblock")
    _check_bound(f"(d) pairwise manhattan, {MANHATTAN_SAMPLE} seeded rows of {CLIP_N}x{CLIP_CLASSES}",
                 manhattan[torch.from_numpy(rows).to(DEVICE)], want, (CLIP_D + 1) * U32 * want, checks)
    want = cdist(cls_host, cls_host, "cityblock")
    _check_bound(f"(d) pairwise manhattan {CLIP_CLASSES}x{CLIP_CLASSES} self, zero diagonal",
                 f.pairwise_manhattan_distance(classes), want, (CLIP_D + 1) * U32 * want, checks)
    pairwise_ms["manhattan"] = _call_ms(lambda: f.pairwise_manhattan_distance(images, classes), reps=3, warmup=1)
    # timed for comparison only: one PyTorch call for the same distances, which the port does not use
    pairwise_ms["torch.cdist p=1 (library)"] = _call_ms(lambda: torch.cdist(images, classes, p=1), reps=3, warmup=1)
    # the least time for each: its inputs read and its matrix written once at the HBM rate, or its
    # float32 operations (a multiply-add per term for the products; a subtract, an absolute value and
    # an add for manhattan) at the rate outside the tensor cores, whichever is longer
    moved = (CLIP_N + CLIP_CLASSES) * CLIP_D * 4 + CLIP_N * CLIP_CLASSES * 4
    terms = CLIP_N * CLIP_CLASSES * CLIP_D
    pairwise_bound = {name: _bound_ms(moved, ops_per_term * terms, FP32_OPS_PER_S)
                      for name, ops_per_term in (("linear", 2), ("cosine", 2), ("euclidean", 2), ("manhattan", 3))}
    print(f"regression (d) pairwise bound (ms, by): {pairwise_bound!r}")
    chunk_rows = max(1, _CHUNK_ELEMENTS // (CLIP_CLASSES * CLIP_D))
    print(f"regression (d) manhattan {CLIP_N}x{CLIP_CLASSES}x{CLIP_D}: peak device memory {manhattan_peak:,} bytes "
          f"above its inputs, in row chunks of {chunk_rows} ({_CHUNK_ELEMENTS:,} elements); the whole difference "
          f"would take {CLIP_N * CLIP_CLASSES * CLIP_D * 4:,} bytes")
    del manhattan
    tf32 = {}
    saved = torch.backends.cuda.matmul.allow_tf32
    if saved:
        raise AssertionError("torch.backends.cuda.matmul.allow_tf32 is on: the float32 checks above assume torch's default")
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        for name, fn in calls.items():
            got = fn(images, classes).cpu().numpy().astype(np.float64)
            tf32[name] = float(np.max(np.abs(got - pairwise_refs[name])))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    print(f"regression (d) with allow_tf32 = True (restored to {saved} after): largest difference from float64 {tf32!r}")

    # timings: each metric alone at full width
    first_a, first_b, first_c = batches_a[0], batches_b[0], batches_c[0]
    members = {f"(a) {k}": (m_, first_a) for k, m_ in _regression_collection_a(mt).items()}
    members.update({f"(b) {k}": (m_, first_b) for k, m_ in _regression_collection_b(mt).items()})
    members.update({f"(c) {k}": (m_, first_c) for k, m_ in members_c().items()})
    updates = _member_timings(members)
    compute_ms = {"(a)": _timed_compute(col_a), "(b)": _timed_compute(col_b), "(c)": _timed_compute(col_c)}
    print(f"regression compute() ms per collection, 3 calls: {compute_ms!r}")
    launches = {route: fn.launches for route, fn in _counters(ops).items()}
    if any(launches.values()):
        raise AssertionError(f"the regression phase launched the stat-scores kernel: {launches}")
    print(f"regression launches per entry point: {launches} (no regression or pairwise function goes through the "
          "stat-scores kernel)")

    # (e) pass (b) and the cosine similarity of pass (c) over two ranks on cuda:0
    sync = phase_regression_sync(out_b, col_b, out_c["cosine"], refs_b)
    secs = time.perf_counter() - phase_start
    passes = {
        "(a) nyu_depth_v2": {"samples_per_s": rate_a, "samples": int(n), "batches": len(batches_a), "peak_bytes": peak_a},
        "(b) movielens": {"samples_per_s": rate_b, "samples": ML_RATINGS, "batches": len(batches_b), "peak_bytes": peak_b},
        "(b) movielens with NaN": {"samples_per_s": rate_nan},
        "(c) distillation": {"samples_per_s": rate_c, "samples": DISTIL_N, "batches": len(batches_c), "peak_bytes": peak_c},
    }
    for name, info in passes.items():
        print(f"regression pass {name}: {info!r}")
    print(f"regression (d) pairwise ms per call: {pairwise_ms!r}")
    print(f"regression phase took {secs:.1f} s")
    line = {"regression": {
        "card": card,
        "passes": passes,
        "updates": updates,
        "compute_ms": compute_ms,
        "pairwise_ms": pairwise_ms,
        "pairwise_bound_ms": pairwise_bound,
        "manhattan_peak_bytes": manhattan_peak,
        "tf32_max_abs_err": tf32,
        "checks": checks,
        "sync": sync,
        "launches": launches,
        "phase_s": secs,
    }}
    return launches, line


def _rank_regression(mt, rank: int, out: Path) -> None:
    """This rank's MovieLens batches and distillation batches, then synced computes; Pearson's
    delta rounds against a twin that always gathers in full."""
    preds, target, _ = _movielens_pass()
    batches = _batched(preds, target, ML_BATCH)
    student, teacher = _distil_pass()
    col = _regression_collection_b(mt)
    cos = mt.CosineSimilarity(reduction="mean", device=DEVICE)
    first, stop = REG_SYNC_SHARDS[rank]
    for p, t in batches[first:stop]:
        col.update(p, t)
    first_c, stop_c = DISTIL_SYNC_SHARDS[rank]
    for p, t in _batched(student, teacher, DISTIL_BATCH)[first_c:stop_c]:
        cos.update(p, t)
    rows = {n: getattr(col["pearson"], n).cpu() for n in ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")}
    torch.cuda.synchronize()
    start = time.perf_counter()
    results = {f"col.{k}": v.cpu() for k, v in col.compute().items()}
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - start) * 1e3
    results["cos"] = cos.compute().cpu()
    with col["mse"].sync_context():
        results.update({"mse.total": col["mse"].total.cpu(), "mse.sum": col["mse"].sum_squared_error.cpu()})
    with col["r2"].sync_context():
        results["r2.total"] = col["r2"].total.cpu()
    with col["spearman"].sync_context():
        rows_equal = bool(torch.equal(col["spearman"].buffer_values("preds"), preds))
    with cos.sync_context():
        rows_equal = rows_equal and bool(torch.equal(cos.buffer_values("preds"), student))
    deltas = []
    metric, twin = mt.PearsonCorrCoef(device=DEVICE), mt.PearsonCorrCoef(device=DEVICE, delta_sync=False)
    for p, t in batches[first : first + 3]:
        metric.update(p, t)
        twin.update(p, t)
        value, twin_value = metric.compute(), twin.compute()
        deltas.append({"equal": bool(torch.equal(value, twin_value)), "delta": metric.last_sync_report["delta"],
                       "value": float(value)})
    torch.save({**results, **{f"row.{k}": v for k, v in rows.items()}}, out / f"rank{rank}.pt")
    (out / f"rank{rank}.json").write_text(json.dumps({
        "rows_equal": rows_equal, "deltas": deltas, "compute_ms": compute_ms,
        "local": not any(m._is_synced for m in col.values()),
        "bytes_gathered": col.aggregate_sync_report()["bytes_gathered"],
    }))


def phase_regression_sync(single: dict, col_b, single_cos: torch.Tensor, refs_b: dict) -> dict:
    """Two ranks on ``cuda:0`` sync pass (b) and the distillation cosine similarity: integer states
    and the buffer metrics bitwise equal to the single-process pass, Pearson (through
    ``_final_aggregation``) and the float sums within their bounds of it and of numpy's."""
    from metrics_tpu_torch.functional.regression.pearson import _pearson_corrcoef_compute
    from metrics_tpu_torch.regression.pearson import _final_aggregation

    with tempfile.TemporaryDirectory(prefix="chip_smoke_regression_") as tmp:
        tmp = Path(tmp)
        start = time.perf_counter()
        seen = _wait_ranks("regression", _start_ranks("regression", tmp / "regression"), tmp / "regression")
        took = time.perf_counter() - start
        got = [torch.load(tmp / "regression" / f"rank{rank}.pt") for rank in range(SYNC_WORLD)]
    print(f"regression sync: two ranks took {took:.1f} s (start-up included)")
    single_sum = col_b["mse"].sum_squared_error.cpu()
    for rank, (info, res) in enumerate(zip(seen, got)):
        if not (info["rows_equal"] and info["local"]):
            raise AssertionError(f"regression sync rank {rank}: gathered rows out of rank order, or state left synced")
        for key, want in (("mse.total", col_b["mse"].total), ("r2.total", col_b["r2"].total)):
            if res[key].dtype != torch.int32 or not torch.equal(res[key], want.cpu()):
                raise AssertionError(f"regression sync rank {rank}: {key} {res[key]!r} differs from the single pass")
        for key, want in (("col.spearman", single["spearman"]), ("cos", single_cos)):
            if not torch.equal(res[key], want.cpu()):
                raise AssertionError(f"regression sync rank {rank}: {key} {res[key]!r} is not the single pass's {want!r}")
        rows = [torch.cat([got[r][f"row.{n}"] for r in range(SYNC_WORLD)])
                for n in ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")]
        merged = float(_pearson_corrcoef_compute(*_final_aggregation(*rows)))
        want, bound = refs_b["pearson"]
        _check_bound(f"(e) rank {rank} pearson", res["col.pearson"], want, bound, {})
        _check_bound(f"(e) rank {rank} pearson against one process", res["col.pearson"], float(single["pearson"]), 2 * bound, {})
        if abs(float(res["col.pearson"]) - merged) > 8 * U32:
            raise AssertionError(f"regression sync rank {rank}: pearson {res['col.pearson']!r} is not the merge of the rows {merged!r}")
        for key in ("mse", "mae", "r2"):
            want, bound = refs_b[key]
            _check_bound(f"(e) rank {rank} {key}", res[f"col.{key}"], want, bound, {})
        # the synced sum is the two ranks' sums added once more
        _check_bound(f"(e) rank {rank} mse sum against one process", res["mse.sum"], float(single_sum),
                     2 * (SUM_DEPTH + 40) * U32 * float(single_sum), {})
        if not all(d["equal"] and d["delta"] is False for d in info["deltas"]) or len({d["value"] for d in info["deltas"]}) != 3:
            raise AssertionError(f"regression sync rank {rank}: Pearson's delta rounds {info['deltas']!r}")
        for key in res:
            if not key.startswith("row.") and not torch.equal(res[key], got[0][key]):
                raise AssertionError(f"regression sync: {key} differs between the ranks")
    print("check regression (e): both ranks' int32 counts, Spearman and cosine similarity bitwise equal to the "
          "single-process pass; Pearson merged by _final_aggregation and the float sums within their bounds; "
          "three Pearson delta rounds equal a delta_sync=False twin, none of them a delta")
    return {"ranks_s": took, "synced_compute_ms_per_rank": [info["compute_ms"] for info in seen],
            "bytes_gathered_per_rank": [info["bytes_gathered"] for info in seen]}


# ------------------------------------------------------------------ wrappers and retrieval (phase 10)
BOOT_COPIES = 100
BOOT_QUANTILES = (0.025, 0.975)
TRACKER_EPOCHS = 3
# QM9 (130,831 molecules after the standard filtering) and its twelve regression targets (mu, alpha, homo,
# lumo, gap, r2, zpve, U0, U, H, G, Cv) at about their standard deviations in the dataset's units
QM9_MOLECULES, QM9_TARGETS, QM9_BATCH, QM9_NAN_SHARE = 130_831, 12, 1024, 0.01
QM9_SCALES = (1.50, 8.19, 0.022, 0.047, 0.048, 280.5, 0.033, 10.3, 10.3, 10.3, 10.3, 4.07)
# MS MARCO passage dev (small): 6,980 queries, each re-ranking BM25's top 1000; about 1.07 judged relevant
# passages a query, and none among the 1000 for about 14 % of queries (BM25's recall@1000 is about 0.857)
MSMARCO_QUERIES, MSMARCO_CANDIDATES, MSMARCO_BATCH = 6_980, 1_000, 64
MSMARCO_NO_RELEVANT, MSMARCO_TWO_RELEVANT = 0.143, 0.075
SCORE_GRID = 64  # scores are multiples of 1/64, so ties occur inside queries
RETRIEVAL_SYNC_SHARDS = ((0, 55), (55, None))  # batch ranges of the two ranks: 55 and 55 batches
# TREC DL 2019 passage judgments: 43 queries, 9,260 judged passages, graded 0-3 in about these shares
TREC_QUERIES, TREC_JUDGED, TREC_GRADE_SHARES = 43, 9_260, (0.557, 0.173, 0.195, 0.075)
PER_QUERY_UNITS = 32  # AP and nDCG per query: a few float32 roundings (and log2's last bit) in units of U32


def _stacked_draws(rng: np.random.Generator, size: int, copies: int, strategy: str) -> Tuple[np.ndarray, np.ndarray]:
    """The JAX package's draws for the copies of a base it stacks (``wrappers/bootstrapping.py:218-293``),
    written out here for the numpy reference: copy i takes the rows ``idx[i, :counts[i]]``."""
    if strategy == "multinomial":
        return np.full(copies, size), rng.integers(0, size, size=(copies, size))
    chunk = min(8, size)
    cap = size + 5 * int(np.ceil(np.sqrt(size))) + 10
    cap = ((cap + chunk - 1) // chunk) * chunk
    counts = np.minimum(rng.poisson(size, copies), cap)
    return counts, rng.integers(0, size, size=(copies, cap))


def _bootstrap_pass(mt, ops, batches, correct: list, strategy: str, checks: dict) -> dict:
    """``BootStrapper(Accuracy)`` over the pass; each copy's counts against the twin draws, bitwise."""
    boot = mt.BootStrapper(mt.Accuracy(num_classes=N_CLASSES, device=DEVICE), num_bootstraps=BOOT_COPIES,
                           quantile=list(BOOT_QUANTILES), raw=True, sampling_strategy=strategy, seed=SEED,
                           device=DEVICE)
    twin = np.random.default_rng(SEED)
    hits, rows, fed = np.zeros(BOOT_COPIES, np.int64), np.zeros(BOOT_COPIES, np.int64), 0
    for (preds, _), ok in zip(batches, correct):
        counts, idx = _stacked_draws(twin, preds.shape[0], BOOT_COPIES, strategy)
        for i in range(BOOT_COPIES):
            hits[i] += ok[idx[i, : counts[i]]].sum()
        rows += counts
        fed += int((counts > 0).sum())

    def run():
        for preds, target in batches:
            boot.update(preds, target)
        return boot.compute()

    out, secs, counts = _driven(ops, f"bootstrap ({strategy})", run, lambda: {"logits": fed, "canonical": 0})
    if not boot._stacked:
        raise AssertionError("BootStrapper(Accuracy) did not take the stacked draws the JAX package takes")
    got_hits = np.array([int(m.tp.sum()) for m in boot.metrics])
    got_rows = np.array([int((m.tp + m.fn).sum()) for m in boot.metrics])
    if not (np.array_equal(got_hits, hits) and np.array_equal(got_rows, rows)):
        raise AssertionError(f"bootstrap ({strategy}): the copies' counts differ from the twin draws'")
    exact = hits / rows
    raw = out["raw"].cpu().numpy().astype(np.float64)
    _check_bound(f"bootstrap {strategy} raw", raw, exact, 2 * U32 * exact, checks, "wrappers/retrieval")
    n = len(exact)
    _check_bound(f"bootstrap {strategy} mean", out["mean"], exact.mean(), (SUM_DEPTH + 4) * U32 * exact.mean(), checks, "wrappers/retrieval")
    spread = 4 * U32 * exact.max()  # each copy's value within 2 units; a difference of two within 4
    _check_bound(f"bootstrap {strategy} std", out["std"], exact.std(ddof=1), spread + (n + 8) * U32 * exact.std(ddof=1), checks, "wrappers/retrieval")
    _check_bound(f"bootstrap {strategy} quantile", out["quantile"], np.quantile(exact, BOOT_QUANTILES), spread, checks, "wrappers/retrieval")
    print(f"check bootstrap ({strategy}): {BOOT_COPIES} copies' hit and row counts bitwise equal to the twin "
          f"generator's draws; {fed} copy updates launched the logits route once each")
    return {"samples_per_s": N_SAMPLES / secs, "copy_updates": fed, "launches": counts}


def _qm9_pass() -> Tuple[torch.Tensor, torch.Tensor]:
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    scales = torch.tensor(QM9_SCALES, device=DEVICE)
    target = torch.randn((QM9_MOLECULES, QM9_TARGETS), generator=gen, device=DEVICE) * scales
    preds = target + 0.1 * scales * torch.randn((QM9_MOLECULES, QM9_TARGETS), generator=gen, device=DEVICE)
    gaps = torch.rand((QM9_MOLECULES, QM9_TARGETS), generator=gen, device=DEVICE) < QM9_NAN_SHARE
    return preds, torch.where(gaps, torch.full_like(target, float("nan")), target)


def _msmarco_pass() -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(query id per row, score, relevance), queries contiguous in the stream and ids not in order."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    q, c = MSMARCO_QUERIES, MSMARCO_CANDIDATES
    ids = torch.randperm(q, generator=gen, device=DEVICE) * 97 + 1185
    u = torch.rand(q, generator=gen, device=DEVICE)
    n_rel = (u >= MSMARCO_NO_RELEVANT).to(torch.int64) + (u >= 1 - MSMARCO_TWO_RELEVANT).to(torch.int64)
    # the relevant passages sit at random places among a query's candidates
    place = torch.rand((q, c), generator=gen, device=DEVICE).argsort(dim=1)
    target = (place < n_rel[:, None]).to(torch.int64)
    # a relevant passage scores 2.1 above the others' N(0, 1): an MRR@10 of about 0.19, BM25's on the dev set
    scores = torch.randn((q, c), generator=gen, device=DEVICE) + 2.1 * target
    scores = torch.round(scores * SCORE_GRID) / SCORE_GRID
    return ids.repeat_interleave(c), scores.reshape(-1), target.reshape(-1)


def _trec_pass() -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    weight = torch.rand(TREC_QUERIES, generator=gen, device=DEVICE) + 0.5
    sizes = (weight / weight.sum() * TREC_JUDGED).floor().to(torch.int64)
    sizes[-1] += TREC_JUDGED - sizes.sum()
    ids = torch.repeat_interleave(torch.arange(TREC_QUERIES, device=DEVICE) * 11 + 19_000, sizes)
    grades = torch.multinomial(torch.tensor(TREC_GRADE_SHARES, device=DEVICE), TREC_JUDGED, replacement=True, generator=gen)
    scores = torch.randn(TREC_JUDGED, generator=gen, device=DEVICE) + 0.7 * grades
    return ids, torch.round(scores * SCORE_GRID) / SCORE_GRID, grades


def _retrieval_collection(mt):
    return mt.MetricCollection({
        "mrr": mt.RetrievalMRR(device=DEVICE),
        "ndcg@10": mt.RetrievalNormalizedDCG(k=10, device=DEVICE),
        "map": mt.RetrievalMAP(device=DEVICE),
        "recall@100": mt.RetrievalRecall(k=100, device=DEVICE),
        "recall@1000": mt.RetrievalRecall(k=1000, device=DEVICE),
        "precision@10": mt.RetrievalPrecision(k=10, device=DEVICE),
        "hit_rate@10": mt.RetrievalHitRate(k=10, device=DEVICE),
        "r_precision": mt.RetrievalRPrecision(device=DEVICE),
        "fall_out@10": mt.RetrievalFallOut(k=10, device=DEVICE),
        "pr_curve": mt.RetrievalPrecisionRecallCurve(max_k=100, device=DEVICE),
        "recall@prec_0_1": mt.RetrievalRecallAtFixedPrecision(min_precision=0.1, max_k=100, device=DEVICE),
    }, device=DEVICE)


def _flat_outputs(out: dict) -> dict:
    """A collection's values with each tuple's parts under ``name.i``."""
    flat = {}
    for key, value in out.items():
        if isinstance(value, tuple):
            flat.update({f"{key}.{i}": part for i, part in enumerate(value)})
        else:
            flat[key] = value
    return flat


def _retrieval_batches(ids, scores, target) -> list:
    """Batches of ``MSMARCO_BATCH`` whole queries."""
    rows = MSMARCO_BATCH * MSMARCO_CANDIDATES
    return [(scores[i : i + rows], target[i : i + rows], ids[i : i + rows]) for i in range(0, ids.shape[0], rows)]


def _retrieval_reference(scores: np.ndarray, target: np.ndarray) -> dict:
    """Per query (a row each), numpy: the stable order of -score, exact counts, float64 scores."""
    q, c = scores.shape
    order = np.argsort(-scores, axis=1, kind="stable")
    t = np.take_along_axis(target, order, axis=1).astype(np.int64)
    cum = np.cumsum(t, axis=1)
    n_rel = cum[:, -1]
    rows = np.arange(q)
    first = np.argmax(t > 0, axis=1) + 1
    disc = 1.0 / np.log2(np.arange(c) + 2.0)
    ideal = -np.sort(-target.astype(np.float64), axis=1)
    idcg = ideal[:, :10] @ disc[:10]
    k = np.arange(1, 101)
    return {
        "order": order, "n_rel": n_rel, "first": np.where(n_rel > 0, first, 0), "hits@10": cum[:, 9],
        "hits@100": cum[:, 99], "hits@R": np.where(n_rel > 0, cum[rows, np.maximum(n_rel, 1) - 1], 0), "cum100": cum[:, :100],
        "ap": np.where(n_rel > 0, (t * cum / np.arange(1, c + 1)).sum(axis=1) / np.maximum(n_rel, 1), 0.0),
        "ndcg@10": np.where(idcg > 0, (t[:, :10] @ disc[:10]) / np.where(idcg > 0, idcg, 1.0), 0.0),
        "curve_p": cum[:, :100] / k, "curve_r": np.where(n_rel[:, None] > 0, cum[:, :100] / np.maximum(n_rel, 1)[:, None], 0.0),
    }


def _ratio32(num, den) -> np.ndarray:
    """float32 num / den of exact counts, each rounded once, as the engine divides them."""
    return np.asarray(num, np.float32) / np.asarray(den, np.float32)


def _check_per_query(engine, preds, target, group, n_groups, ref: dict, by_group: np.ndarray) -> dict:
    """The engine's per-query order, ranks and ratios of counts against numpy, bitwise; AP and nDCG
    within ``PER_QUERY_UNITS`` units."""
    c = MSMARCO_CANDIDATES
    order, _, rank, counts, _ = engine._group_layout(preds, group, n_groups)
    want_order = (ref["order"] + np.arange(len(by_group))[:, None] * c)[by_group].reshape(-1)
    if not np.array_equal(order.cpu().numpy(), want_order) or not torch.equal(counts.cpu(), torch.full((n_groups,), c)):
        raise AssertionError("retrieval: the engine's order differs from numpy's stable per-query argsort")
    if not np.array_equal(rank.cpu().numpy(), np.tile(np.arange(c), n_groups)):
        raise AssertionError("retrieval: the engine's ranks are not 0..999 in every query")
    r = {key: value[by_group] for key, value in ref.items() if key != "order"}
    has = r["n_rel"] > 0
    exact = {
        "reciprocal_rank": (engine.reciprocal_rank_per_group(preds, target, group, n_groups),
                            np.where(has, _ratio32(1, np.maximum(r["first"], 1)), np.float32(0))),
        "precision@10": (engine.precision_per_group(preds, target, group, n_groups, k=10), _ratio32(r["hits@10"], 10)),
        "recall@100": (engine.recall_per_group(preds, target, group, n_groups, k=100),
                       _ratio32(r["hits@100"], np.maximum(r["n_rel"], 1))),
        "hit_rate@10": (engine.hit_rate_per_group(preds, target, group, n_groups, k=10), (r["hits@10"] > 0).astype(np.float32)),
        "fall_out@10": (engine.fall_out_per_group(preds, target, group, n_groups, k=10), _ratio32(10 - r["hits@10"], c - r["n_rel"])),
        "r_precision": (engine.r_precision_per_group(preds, target, group, n_groups),
                        _ratio32(r["hits@R"], np.maximum(r["n_rel"], 1))),
    }
    curve_p, curve_r = engine.precision_recall_curve_per_group(preds, target, group, n_groups, max_k=100)
    exact["curve precision"] = (curve_p, _ratio32(r["cum100"], np.arange(1, 101)))
    exact["curve recall"] = (curve_r, _ratio32(r["cum100"], np.maximum(r["n_rel"], 1)[:, None]))
    for name, (got, want) in exact.items():
        if got.cpu().numpy().tobytes() != want.tobytes():
            raise AssertionError(f"retrieval per query {name}: not bitwise equal to numpy's float32 ratio of exact counts")
    worst = {}
    for name, got, want in (("ap", engine.average_precision_per_group(preds, target, group, n_groups), r["ap"]),
                            ("ndcg@10", engine.ndcg_per_group(preds, target, group, n_groups, k=10), r["ndcg@10"])):
        diff = np.abs(got.cpu().numpy().astype(np.float64) - want)
        worst[name] = float(diff.max() / (PER_QUERY_UNITS * U32))
        if worst[name] > 1:
            raise AssertionError(f"retrieval per query {name}: off numpy float64 by {diff.max()!r}")
    print(f"check retrieval per query ({n_groups} queries): order, ranks and counts bitwise; reciprocal rank, "
          f"precision@10, recall@100, hit rate@10, fall-out@10, R-precision and the 100-point curves bitwise equal to "
          f"numpy's float32 ratios of exact counts; AP and nDCG@10 within {worst} of {PER_QUERY_UNITS} units")
    return worst


def _mean_bound(values: np.ndarray) -> float:
    """A float32 mean over queries: PyTorch's reduction depth, one division, and each query's own rounding."""
    return (SUM_DEPTH + PER_QUERY_UNITS + 2) * U32 * float(np.abs(values).mean())


def _retrieval_means(out: dict, ref: dict, checks: dict) -> None:
    n_rel, has = ref["n_rel"], ref["n_rel"] > 0
    c = MSMARCO_CANDIDATES
    per_query = {
        "mrr": np.where(has, 1.0 / np.maximum(ref["first"], 1), 0.0),
        "ndcg@10": ref["ndcg@10"],
        "map": ref["ap"],
        "recall@100": np.where(has, ref["hits@100"] / np.maximum(n_rel, 1), 0.0),
        "recall@1000": has.astype(np.float64),
        "precision@10": ref["hits@10"] / 10,
        "hit_rate@10": (ref["hits@10"] > 0).astype(np.float64),
        "r_precision": np.where(has, ref["hits@R"] / np.maximum(n_rel, 1), 0.0),
        "fall_out@10": (10 - ref["hits@10"]) / (c - n_rel),
    }
    for name, values in per_query.items():
        _check_bound(f"retrieval {name}", out[name], values.mean(), _mean_bound(values), checks, "wrappers/retrieval")
    curve_p, curve_r = ref["curve_p"].mean(axis=0), ref["curve_r"].mean(axis=0)
    _check_bound("retrieval curve precision", out["pr_curve.0"], curve_p, _mean_bound(ref["curve_p"]), checks, "wrappers/retrieval")
    _check_bound("retrieval curve recall", out["pr_curve.1"], curve_r, _mean_bound(ref["curve_r"]), checks, "wrappers/retrieval")
    if not torch.equal(out["pr_curve.2"].cpu(), torch.arange(1, 101, dtype=torch.int32)):
        raise AssertionError("retrieval curve: top_k is not 1..100")
    # recall at precision >= 0.1: the largest (recall, k) among the ks that reach it; (0, max_k) without one
    reach = [(r, k) for r, k, p in zip(curve_r, range(1, 101), curve_p) if p >= 0.1]
    r_want, k_want = max(reach) if reach else (0.0, 100)
    k_want = 100 if r_want == 0.0 else k_want
    near = np.abs(curve_p - 0.1) <= _mean_bound(ref["curve_p"])
    recall, k_got = out["recall@prec_0_1.0"], int(out["recall@prec_0_1.1"])
    if k_got != k_want and not near.any():
        raise AssertionError(f"retrieval recall@prec_0_1: k {k_got} where numpy's curve gives {k_want}")
    _check_bound("retrieval recall@prec_0_1", recall, r_want if k_got == k_want else curve_r[k_got - 1],
                 _mean_bound(ref["curve_r"]), checks, "wrappers/retrieval")
    print(f"check retrieval recall@prec_0_1: k {k_got} (numpy's curve gives {k_want})")


def _rank_retrieval(mt, rank: int, out: Path) -> None:
    """This rank's share of the MS MARCO batches, then a synced compute of the collection."""
    batches = _retrieval_batches(*_msmarco_pass())
    first, stop = RETRIEVAL_SYNC_SHARDS[rank]
    col = _retrieval_collection(mt)
    for preds, target, ids in batches[first:stop]:
        col.update(preds, target, indexes=ids)
    torch.cuda.synchronize()
    start = time.perf_counter()
    results = {k: v.cpu() for k, v in _flat_outputs(col.compute()).items()}
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - start) * 1e3
    torch.save(results, out / f"rank{rank}.pt")
    (out / f"rank{rank}.json").write_text(json.dumps({
        "compute_ms": compute_ms, "groups": list(col.compute_groups.values()),
        "local": not any(m._is_synced for m in col.values()),
        "bytes_gathered": col.aggregate_sync_report()["bytes_gathered"],
    }))


def phase_retrieval_sync(single: dict) -> dict:
    """Two ranks on ``cuda:0`` sync the MS MARCO collection; both must equal the single-process pass bitwise."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_retrieval_") as tmp:
        where = Path(tmp) / "retrieval"
        start = time.perf_counter()
        seen = _wait_ranks("retrieval", _start_ranks("retrieval", where), where)
        took = time.perf_counter() - start
        got = [torch.load(where / f"rank{rank}.pt") for rank in range(SYNC_WORLD)]
    for rank, (info, res) in enumerate(zip(seen, got)):
        if not info["local"] or len(info["groups"]) != 1:
            raise AssertionError(f"retrieval sync rank {rank}: {info}")
        for key, value in single.items():
            if not _same_values(res[key], value.cpu()):
                raise AssertionError(f"retrieval sync rank {rank}: {key} differs from the single-process pass")
    print(f"check retrieval sync: both ranks' eleven values bitwise equal to the single-process pass "
          f"({took:.1f} s with start-up; synced compute() ms per rank {[i['compute_ms'] for i in seen]!r}, "
          f"bytes gathered {[i['bytes_gathered'] for i in seen]!r})")
    return {"ranks_s": took, "synced_compute_ms_per_rank": [i["compute_ms"] for i in seen],
            "bytes_gathered_per_rank": [i["bytes_gathered"] for i in seen]}


def _card_vs_cpu_retrieval(engine) -> dict:
    """The engine on the card against the plain CPU path on tied, signed-zero and NaN scores."""
    gen = np.random.default_rng(SEED + 13)
    ids = np.repeat(gen.permutation(300) * 7 + 5, 40)
    scores = (gen.integers(-8, 9, ids.size) / 8).astype(np.float32)
    scores[gen.random(ids.size) < 0.05] = -0.0
    scores[gen.random(ids.size) < 0.03] = np.nan
    target = (gen.random(ids.size) < 0.2).astype(np.int32)
    target[ids == ids[0]] = 0
    host = [torch.from_numpy(a) for a in (scores, target)]
    card = [t.to(DEVICE) for t in host]
    group, n = engine.contiguous_groups(torch.from_numpy(ids))
    group_card, n_card = engine.contiguous_groups(torch.from_numpy(ids).to(DEVICE))
    if n_card != n or not torch.equal(group_card.cpu(), group):
        raise AssertionError("card vs CPU: the query groupings differ")
    for a, b in zip(engine._group_layout(card[0], group_card, n), engine._group_layout(host[0], group, n)):
        if not torch.equal(a.cpu(), b):
            raise AssertionError("card vs CPU: the order or the ranks differ")
    worst = 0.0
    for name in ("reciprocal_rank_per_group", "precision_per_group", "recall_per_group", "fall_out_per_group",
                 "hit_rate_per_group", "r_precision_per_group", "average_precision_per_group", "ndcg_per_group"):
        fn = getattr(engine, name)
        got, again, want = fn(*card, group_card, n), fn(*card, group_card, n), fn(*host, group, n)
        if got.cpu().numpy().tobytes() != again.cpu().numpy().tobytes():
            raise AssertionError(f"card vs CPU: two card runs of {name} differ")
        diff = float((got.cpu() - want).abs().max())
        if name in ("average_precision_per_group", "ndcg_per_group"):
            worst = max(worst, diff / (PER_QUERY_UNITS * U32))
            if diff > PER_QUERY_UNITS * U32:
                raise AssertionError(f"card vs CPU: {name} off by {diff!r}")
        elif got.cpu().numpy().tobytes() != want.numpy().tobytes():
            raise AssertionError(f"card vs CPU: {name} differs")
    print(f"check retrieval card vs CPU (300 queries of 40, ties, +-0.0, NaN): groupings, order and ranks bitwise, "
          f"ratio scores bitwise, AP and nDCG within {worst:.3g} of {PER_QUERY_UNITS} units, two card runs bitwise")
    return {"ap_ndcg_worst_share": worst}


def phase_wrappers_retrieval(mt, ops, card: str) -> Tuple[dict, dict]:
    """(a) the wrappers on the ImageNet pass, (b) a multi-output wrapper on a QM9-shaped regression,
    (c) retrieval on MS MARCO-shaped re-ranking and a TREC-DL-shaped graded pass, the card against the
    CPU, and a two-rank sync; each against numpy."""
    from metrics_tpu_torch.functional.retrieval import engine

    phase_start = time.perf_counter()
    checks, passes, launches = {}, {}, {route: 0 for route in _counters(ops)}

    def add(counts):
        for route, n in counts.items():
            launches[route] += n

    # (a) the wrappers on the ImageNet-1k pass
    logits, labels, batches = _imagenet_pass()
    ref = _reference(logits, labels)
    pred_host, label_host = logits.argmax(dim=1).cpu().numpy(), labels.cpu().numpy()
    correct = [pred_host[i : i + BATCH] == label_host[i : i + BATCH] for i in range(0, N_SAMPLES, BATCH)]
    n_batches = len(batches)

    cw = mt.ClasswiseWrapper(mt.Accuracy(num_classes=N_CLASSES, average=None, device=DEVICE), device=DEVICE)

    def run_cw():
        for preds, target in batches:
            cw.update(preds, target)
        return cw.compute()

    out_cw, secs, counts = _driven(ops, "classwise", run_cw, lambda: {"logits": n_batches, "canonical": 0})
    add(counts)
    cm = ref["cm"]
    per_class = np.diag(cm) / cm.sum(axis=1)
    if list(out_cw) != [f"accuracy_{i}" for i in range(N_CLASSES)]:
        raise AssertionError("classwise: the keys are not accuracy_0..accuracy_999")
    _check_bound("classwise accuracy", torch.stack(list(out_cw.values())), per_class, 2 * U32 * per_class, checks, "wrappers/retrieval")
    passes["(a) classwise"] = {"samples_per_s": N_SAMPLES / secs}

    mm = mt.MinMaxMetric(mt.Accuracy(num_classes=N_CLASSES, device=DEVICE), device=DEVICE)

    def run_mm():
        return [mm(preds, target) for preds, target in batches], mm.compute()

    (steps, out_mm), secs, counts = _driven(ops, "minmax", run_mm, lambda: {"logits": n_batches, "canonical": 0})
    add(counts)
    batch_acc = np.array([ok.mean() for ok in correct])
    _check_bound("minmax batch values", torch.stack([s["raw"] for s in steps]), batch_acc, 2 * U32 * batch_acc, checks, "wrappers/retrieval")
    _check_bound("minmax min", out_mm["min"], batch_acc.min(), 2 * U32 * batch_acc.min(), checks, "wrappers/retrieval")
    _check_bound("minmax max", out_mm["max"], batch_acc.max(), 2 * U32 * batch_acc.max(), checks, "wrappers/retrieval")
    _check_bound("minmax raw", out_mm["raw"], ref["micro_acc"], 2 * U32 * ref["micro_acc"], checks, "wrappers/retrieval")
    passes["(a) minmax"] = {"samples_per_s": N_SAMPLES / secs}

    for strategy in ("poisson", "multinomial"):
        info = _bootstrap_pass(mt, ops, batches, correct, strategy, checks)
        add(info.pop("launches"))
        passes[f"(a) bootstrap {strategy}"] = info

    tracker = mt.MetricTracker(_config2(mt), maximize=[True, True, True, True])

    def run_tracker():
        for _ in range(TRACKER_EPOCHS):
            tracker.increment()
            for preds, target in batches:
                tracker.update(preds, target)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            best = tracker.best_metric(return_step=True)
        return best, tracker.compute_all(), seen

    def implied_tracker():
        total = {route: 0 for route in _counters(ops)}
        for step in tracker:
            for route, n in _implied_config2(ops, step, n_batches).items():
                total[route] += n
        return total

    (best, all_steps, seen), secs, counts = _driven(ops, "tracker", run_tracker, implied_tracker)
    add(counts)
    value, step = best
    if value["cm"] is not None or step["cm"] is not None or not any("not a scalar" in str(w.message) for w in seen):
        raise AssertionError("tracker: the confusion matrix has no best value; expected None with a warning")
    for key, want in (("acc", ref["macro_acc"]), ("f1", ref["macro_f1"]), ("prec", ref["macro_precision"])):
        if step[key] != 0:
            raise AssertionError(f"tracker: equal epochs must give step 0 as the best {key}, got {step[key]}")
        _check_close(f"tracker best {key}", torch.tensor(value[key]), want)
    for epoch in range(TRACKER_EPOCHS):
        if not np.array_equal(all_steps["cm"][epoch].cpu().numpy(), cm):
            raise AssertionError(f"tracker: epoch {epoch}'s confusion matrix differs from numpy's bincount")
    passes["(a) tracker"] = {"samples_per_s": TRACKER_EPOCHS * N_SAMPLES / secs, "epochs": TRACKER_EPOCHS}
    fresh_tracker = mt.MetricTracker(_config2(mt), maximize=True)
    fresh_tracker.increment()
    update_a = _member_timings({
        "classwise": (mt.ClasswiseWrapper(mt.Accuracy(num_classes=N_CLASSES, average=None, device=DEVICE), device=DEVICE),
                      batches[0]),
        "minmax": (mt.MinMaxMetric(mt.Accuracy(num_classes=N_CLASSES, device=DEVICE), device=DEVICE), batches[0]),
        f"bootstrap poisson ({BOOT_COPIES} copies)": (
            mt.BootStrapper(mt.Accuracy(num_classes=N_CLASSES, device=DEVICE), num_bootstraps=BOOT_COPIES, device=DEVICE),
            batches[0]),
        "tracker (config 2)": (fresh_tracker, batches[0]),
    })
    del logits, labels, batches

    # (b) a multi-output wrapper on a QM9-shaped regression with missing targets
    preds_b, target_b = _qm9_pass()
    batches_b = _batched(preds_b, target_b, QM9_BATCH)
    mo = mt.MultioutputWrapper(mt.MeanAbsoluteError(device=DEVICE), num_outputs=QM9_TARGETS, device=DEVICE)
    out_b, rate_b, peak_b = _regression_pass(mo, batches_b)
    p_host, t_host = preds_b.cpu().numpy().astype(np.float64), target_b.cpu().numpy().astype(np.float64)
    keep = ~np.isnan(t_host)
    depth_b = SUM_DEPTH + len(batches_b) + 1
    for j in range(QM9_TARGETS):
        err = np.abs(p_host[keep[:, j], j] - t_host[keep[:, j], j])
        if int(mo.metrics[j].total) != int(keep[:, j].sum()):
            raise AssertionError(f"multioutput target {j}: counted {int(mo.metrics[j].total)} rows, not {int(keep[:, j].sum())}")
        _check_bound(f"multioutput target {j} MAE", out_b[j], err.mean(), (depth_b + 2) * U32 * err.mean(), checks, "wrappers/retrieval")
    fresh = mt.MultioutputWrapper(mt.MeanAbsoluteError(device=DEVICE), num_outputs=QM9_TARGETS, device=DEVICE)
    update_b = _member_timings({"multioutput (12 MAE)": (fresh, batches_b[0])})
    passes["(b) qm9 multioutput"] = {"samples_per_s": rate_b, "samples": QM9_MOLECULES, "batches": len(batches_b),
                                     "peak_bytes": peak_b, "nan_targets": int((~keep).sum())}
    del preds_b, target_b, batches_b

    # (c) retrieval: MS MARCO passage dev (small) re-ranking
    ids, scores, target = _msmarco_pass()
    batches_c = _retrieval_batches(ids, scores, target)
    warm = _retrieval_collection(mt)
    warm.update(*batches_c[0][:2], indexes=batches_c[0][2])
    warm.compute()
    col = _retrieval_collection(mt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    for preds, tgt, idx in batches_c:
        col.update(preds, tgt, indexes=idx)
    out_c = _flat_outputs(col.compute())
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    peak_c = torch.cuda.max_memory_allocated()
    if len(col.compute_groups) != 1:
        raise AssertionError(f"retrieval: the eleven members share one buffer set; groups {col.compute_groups}")
    for m in col.values():
        m._computed = None
    again = _flat_outputs(col.compute())
    for key, value in out_c.items():
        if value.cpu().numpy().tobytes() != again[key].cpu().numpy().tobytes():
            raise AssertionError(f"retrieval: two card compute() calls of {key} differ")
    print("check retrieval: two compute() calls on the card bitwise equal")
    q, c = MSMARCO_QUERIES, MSMARCO_CANDIDATES
    s_host, t_host = scores.cpu().numpy().reshape(q, c), target.cpu().numpy().reshape(q, c)
    ids_host = ids.cpu().numpy()[::c]
    ref_c = _retrieval_reference(s_host, t_host)
    _retrieval_means(out_c, ref_c, checks)
    group, n_groups = engine.contiguous_groups(col["map"].buffer_values("indexes"))
    per_query = _check_per_query(engine, col["map"].buffer_values("preds"), col["map"].buffer_values("target"),
                                 group, n_groups, ref_c, np.argsort(ids_host))
    compute_c = _timed_compute(col)
    member_ms = {}
    for name, m in col.items():
        times = []
        for _ in range(3):
            m._computed = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m.compute()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        member_ms[name] = statistics.median(times)
    print(f"retrieval compute() ms per member (median of 3): {member_ms!r}")
    def map_compute():
        col["map"]._computed = None  # a cached value would skip the work
        return col["map"].compute()

    map_ops = max(((_device_ops(map_compute) or []) for _ in range(PROFILER_ATTEMPTS)), key=len)
    by_op: dict = {}
    for op, ms in map_ops:
        name = op.split("<")[0].split("(")[0][-60:]
        by_op[name] = by_op.get(name, 0.0) + ms
    top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:6]
    print(f"RetrievalMAP.compute() on the card: {len(map_ops)} device operations, {sum(by_op.values())!r} ms of their "
          f"own time; the largest: {top_ops!r}")
    update_c = _member_timings({"retrieval collection (11 members, one group)": (_retrieval_collection(mt), batches_c[0])})
    passes["(c) msmarco"] = {"samples_per_s": q * c / secs, "queries_per_s": q / secs, "rows": q * c,
                             "batches": len(batches_c), "peak_bytes": peak_c, "per_query_worst_share": per_query}

    # TREC DL 2019-shaped graded judgments: nDCG@10
    ids_t, scores_t, grades = _trec_pass()
    ndcg = mt.RetrievalNormalizedDCG(k=10, device=DEVICE)
    for qid in torch.unique_consecutive(ids_t):
        rows = ids_t == qid
        ndcg.update(scores_t[rows], grades[rows], indexes=ids_t[rows])
    ids_h, s_h, g_h = (x.cpu().numpy() for x in (ids_t, scores_t, grades))
    per_q = []
    for qid in np.unique(ids_h):
        rows = ids_h == qid
        t_sorted = g_h[rows][np.argsort(-s_h[rows], kind="stable")].astype(np.float64)[:10]
        ideal = -np.sort(-g_h[rows].astype(np.float64))[:10]
        disc = 1.0 / np.log2(np.arange(len(t_sorted)) + 2.0)
        idcg = ideal @ disc[: len(ideal)]
        per_q.append(t_sorted @ disc / idcg if idcg > 0 else 0.0)
    per_q = np.array(per_q)
    _check_bound("retrieval TREC DL nDCG@10", ndcg.compute(), per_q.mean(), _mean_bound(per_q), checks, "wrappers/retrieval")
    got_q = engine.ndcg_per_group(ndcg.buffer_values("preds"), ndcg.buffer_values("target"),
                                  *engine.contiguous_groups(ndcg.buffer_values("indexes")), k=10)
    _check_bound("retrieval TREC DL nDCG@10 per query", got_q, per_q, PER_QUERY_UNITS * U32 * np.maximum(per_q, 1e-30), checks, "wrappers/retrieval")

    card_cpu = _card_vs_cpu_retrieval(engine)
    single = {k: v for k, v in out_c.items()}
    del ids, scores, target, batches_c, col, warm
    torch.cuda.empty_cache()
    sync = phase_retrieval_sync(single)

    secs = time.perf_counter() - phase_start
    for name, info in passes.items():
        print(f"wrappers/retrieval pass {name}: {info!r}")
    print(f"wrappers/retrieval launches per entry point: {launches}")
    print(f"wrappers/retrieval phase took {secs:.1f} s")
    line = {"wrappers_retrieval": {
        "card": card,
        "passes": passes,
        "updates": {**update_a, **update_b, **update_c},
        "compute_ms": {"(c) collection, 3 calls": compute_c, "(c) per member": member_ms},
        "map_compute_top_device_ops_ms": top_ops,
        "checks": checks,
        "card_vs_cpu": card_cpu,
        "sync": sync,
        "launches": launches,
        "phase_s": secs,
    }}
    return launches, line


# ---------------------------------------------------------------- streaming
SKETCH_Q = (0.5, 0.9, 0.95, 0.99)
SKETCH_CAPACITY, SKETCH_MAX_ITEMS = 2048, 1 << 28  # the quantiles' sketch: 18 levels
HIST_BINS = 20  # StreamingHistogram at the default capacity 256 (21 levels at max_items 2**28)
PREFIX_CHUNKS = 300  # chunks of the NYU stream that the kernel and its plain version both fold
EDGE_CAPACITIES = (8, 256, 2048)  # the card against the plain version on tricky values
BATCHED_SKETCHES = 8  # sketches folded in one launch
RAW_CHUNKS = 400  # raw chunks per sketch in (b)'s edge cases
WINDOW_BUCKET = 5  # ImageNet batches per window bucket
WINDOW_EPOCHS = 2  # passes through the windows, so that full windows evict buckets
ACC_WINDOW, CE_WINDOW = 10, 8
ML_HALF_LIFE = 100.0
STREAM_SYNC_SHARDS = ((0, 30), (30, None))  # NYU batch ranges of the two ranks: 30 and 52 batches
RING_WINDOW, RING_ADVANCES = 4, 3  # the synced ring: buckets, and the advances each rank makes in its share


def _absrel_stream() -> torch.Tensor:
    """The NYU pass's per-pixel absolute relative error |p - t| / t, all of it, on the card (float32)."""
    return torch.cat([(p - t).abs_().div_(t) for p, t in _nyu_pass()])


def _stream_batches(err: torch.Tensor) -> list:
    per = NYU_BATCH * NYU_H * NYU_W
    return [err[i : i + per] for i in range(0, err.numel(), per)]


def _exact_counts(ordered: np.ndarray, points: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """For each point x: #(data < x) and #(data <= x), exact, from the data sorted once (numpy on the host)."""
    return np.searchsorted(ordered, points, side="left"), np.searchsorted(ordered, points, side="right")


def _rank_errors(estimates: np.ndarray, qs, data: np.ndarray) -> np.ndarray:
    """Normalized rank error of each estimate of quantile q: how far q n lies outside the estimate's
    exact rank interval [#(< x), #(<= x)], over n; ``data`` sorted."""
    lt, le = _exact_counts(data, estimates.astype(np.float32))
    target = np.asarray(qs, np.float64) * data.size
    return np.maximum(0.0, np.maximum(lt - target, target - le)) / data.size


def _round32(exact) -> np.float32:
    """A Fraction rounded once to float32 (to nearest, ties to even)."""
    from fractions import Fraction

    guess = np.float32(float(exact))
    cands = [np.nextafter(guess, np.float32(-np.inf)), guess, np.nextafter(guess, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - exact), int(c.view(np.uint32)) & 1))


def _histogram_check(out: dict, data: np.ndarray, eps: float, checks: dict) -> None:
    """Edges: the data's min and max, each inner edge lo + (hi - lo) x grid rounded once (float32);
    counts within eps n of np.histogram's over those edges, and their sum within eps n of n;
    ``data`` sorted."""
    from fractions import Fraction

    from metrics_tpu_torch.utils.data import _linspace_thresholds

    edges = out["edges"].cpu().numpy()
    lo, hi = data.min(), data.max()
    span = np.float32(hi - lo)
    want = [_round32(Fraction(float(span)) * Fraction(float(g)) + Fraction(float(lo)))
            for g in _linspace_thresholds(HIST_BINS + 1)]
    if edges[0] != lo or edges[-1] != hi or edges.tobytes() != np.array(want, np.float32).tobytes():
        raise AssertionError(f"histogram edges {edges!r} are not the data's range cut at the exact grid {want!r}")
    lt, le = _exact_counts(data, edges)
    exact = np.diff(lt).astype(np.float64)  # np.histogram's bins: [e_i, e_{i+1}), the last one closed
    exact[-1] += le[-1] - lt[-1]
    got = out["counts"].cpu().numpy().astype(np.float64)
    worst = np.abs(got - exact).max() / data.size
    checks["(a) histogram counts"] = {"worst_rank_error": worst, "bound": eps, "total": float(got.sum())}
    print(f"check streaming histogram: {HIST_BINS} bins over [{lo!r}, {hi!r}], worst |count - np.histogram| / n "
          f"{worst!r} (bound {eps!r}), counts sum {got.sum()!r} of {data.size}")
    if worst > eps or abs(got.sum() - data.size) > eps * data.size:
        raise AssertionError("streaming histogram counts outside the sketch's bound")


def _with_plain_fold(fn):
    """``fn()`` with the sketch functions folding through the plain version (comparisons only)."""
    import metrics_tpu_torch.streaming.sketches as sk
    from metrics_tpu_torch.ops import kll

    sk.kll_fold = kll.kll_fold_plain
    try:
        return fn()
    finally:
        sk.kll_fold = kll.kll_fold


def _same_leaves(name: str, a: dict, b: dict) -> int:
    if sorted(a) != sorted(b):
        raise AssertionError(f"{name}: leaves {sorted(a)} and {sorted(b)}")
    for k in a:
        x, y = a[k].cpu(), b[k].cpu()
        if x.dtype != y.dtype or x.shape != y.shape or x.numpy().tobytes() != y.numpy().tobytes():
            raise AssertionError(f"{name}: leaf {k!r} differs")
    return len(a)


def _tricky_stream(seed: int, size: int) -> torch.Tensor:
    """Values on a grid of hundredths (ties), both signed zeros, NaN, both infinities, and a tail of NaN
    long enough to make whole chunks of padding."""
    rng = np.random.default_rng(seed)
    v = np.round(rng.normal(size=size), 2).astype(np.float32)
    v[::7], v[3::11] = 0.0, -0.0
    v[[1, 2, 4, 5]] = [np.nan, np.inf, -np.inf, -np.nan]
    v[-(size // 8):] = np.nan
    return torch.from_numpy(v)


def _card_vs_plain_sketches(sk, err: torch.Tensor, last: torch.Tensor, deep: dict) -> dict:
    """Every leaf of the kernel's folds bitwise against the plain version on the card and on the CPU.

    ``deep`` holds, for each metric of (a), its sketch before and after the main path's launch on
    ``last``, a full batch late in the stream: the plain version folds it into the same deep state."""
    compared, cases = 0, 0
    deep_ms = {}
    for name, (before, after) in deep.items():
        torch.cuda.synchronize()
        start = time.perf_counter()
        plain = _with_plain_fold(lambda: sk.kll_update(before, last))
        torch.cuda.synchronize()
        deep_ms[name] = (time.perf_counter() - start) * 1e3
        levels, capacity = before["buf"].shape
        compared += _same_leaves(f"the {name}'s main-path update on a full batch (capacity {capacity}, {levels} levels, "
                                 f"n {int(before['n'])} before it)", after, plain)
        cases += 1
    print(f"check kll_fold: the main path's update on the last full batch, for each sketch of (a), from the same deep state, "
          f"bitwise equal to the plain version; the plain version took {deep_ms!r} ms")
    for capacity, max_items in ((SKETCH_CAPACITY, SKETCH_MAX_ITEMS), (256, SKETCH_MAX_ITEMS), (8, 1 << 20)):
        prefix = err[: PREFIX_CHUNKS * capacity // 2]
        empty = sk.kll_init(capacity, max_items=max_items, device=DEVICE)
        card = sk.kll_update(empty, prefix)
        plain = _with_plain_fold(lambda: sk.kll_update(empty, prefix))
        cpu = sk.kll_update(sk.kll_init(capacity, max_items=max_items, device="cpu"), prefix.cpu())
        compared += _same_leaves(f"prefix at capacity {capacity}, plain", card, plain)
        compared += _same_leaves(f"prefix at capacity {capacity}, cpu", card, cpu)
        cases += 1
    for capacity in EDGE_CAPACITIES:
        max_items = 1 << 20
        a = b = sk.kll_init(capacity, seed=3, max_items=max_items, device=DEVICE)
        for step in range(3):
            v = _tricky_stream(step, capacity * 37 + 5).to(DEVICE)
            a = sk.kll_update(a, v)
            b = _with_plain_fold(lambda: sk.kll_update(b, v))
        compared += _same_leaves(f"tricky values at capacity {capacity}", a, b)
        empty = sk.kll_init(capacity, seed=5, max_items=max_items, device=DEVICE)
        for order in ([a, empty, a], [empty, a], [empty, empty]):
            compared += _same_leaves(f"merge at capacity {capacity}", sk.kll_merge(order),
                                     _with_plain_fold(lambda: sk.kll_merge(order)))
        cases += 4
    inits = [sk.kll_init(256, seed=i, max_items=SKETCH_MAX_ITEMS, device=DEVICE) for i in range(BATCHED_SKETCHES)]
    batch = {k: torch.stack([s[k] for s in inits]) for k in inits[0]}
    values = torch.stack([_tricky_stream(10 + i, 6000) for i in range(BATCHED_SKETCHES)]).to(DEVICE)
    card = sk.kll_update(batch, values)
    compared += _same_leaves("a batch of 8 sketches", card, _with_plain_fold(lambda: sk.kll_update(batch, values)))
    compared += _same_leaves("a batch of 8 merges", sk.kll_merge([card, batch, card]),
                             _with_plain_fold(lambda: sk.kll_merge([card, batch, card])))
    cases += 2
    raw_leaves, raw_cases = _card_vs_plain_raw(sk)
    compared, cases = compared + raw_leaves, cases + raw_cases
    print(f"check kll_fold: {compared} leaves over {cases} cases bitwise equal to the plain version (on the card, and "
          f"on the CPU for the NYU prefixes of {PREFIX_CHUNKS} chunks at capacities {SKETCH_CAPACITY}, 256 and 8)")
    return {"cases": cases, "leaves": compared, "deep_plain_ms": deep_ms}


def _raw_chunks(rng: np.random.Generator, sketches: int, n: int, half: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunks as a caller of ``kll_fold`` may pass them: values on a grid of hundredths with both signed
    zeros; random valid counts (odd ones: many short runs in a row), a fifth all padding (0 or -1), the
    rest +inf; sketches 0, 2, ... sorted, the others not (the bitonic sort); NaN inside sketch 1's runs."""
    vals = np.round(rng.normal(size=(sketches, n, half)), 2).astype(np.float32)
    vals[..., ::7], vals[..., 3::11] = 0.0, -0.0
    valids = rng.integers(1, half + 1, (sketches, n))
    valids[rng.random((sketches, n)) < 0.3] = half
    valids[rng.random((sketches, n)) < 0.2] = 0
    valids[rng.random((sketches, n)) < 0.03] = -1
    vals[1, ::5, 1] = np.nan  # inside the run where the count passes 1
    vals = np.where(np.arange(half) < valids[..., None], vals, np.float32(np.inf))
    vals[::2] = np.sort(vals[::2], axis=-1, kind="stable")
    return torch.from_numpy(vals), torch.from_numpy(valids.astype(np.int32))


def _card_vs_plain_raw(sk) -> Tuple[int, int]:
    """``kll_fold`` itself against its plain version on the card, at both main-path capacities: raw chunks
    (partial, all padding, unsorted, NaN inside) into 8 sketches mid-stream, at level 0 and at every level
    (as a merge folds them); 8 such sketches merged; and a stream past ``max_items`` (the top level
    compacts in place, a chain of events)."""
    from metrics_tpu_torch.ops import kll

    compared = cases = 0
    for capacity in (SKETCH_CAPACITY, 256):
        half = capacity // 2
        rng = np.random.default_rng(capacity)
        inits = [sk.kll_init(capacity, seed=i, max_items=SKETCH_MAX_ITEMS, device=DEVICE) for i in range(BATCHED_SKETCHES)]
        batch = {k: torch.stack([st[k] for st in inits]) for k in inits[0]}
        batch = sk.kll_update(batch, torch.from_numpy(rng.random((BATCHED_SKETCHES, 40 * half), np.float32)).to(DEVICE))
        n_levels = batch["buf"].shape[1]
        n = RAW_CHUNKS
        for spread in (False, True):
            chunks, valids = (x.to(DEVICE) for x in _raw_chunks(rng, BATCHED_SKETCHES, n, half))
            at = rng.integers(0, n_levels if spread else 1, n).astype(np.int32)
            levels = torch.from_numpy(at).to(DEVICE)
            card = {k: batch[k].clone() for k in ("buf", "cnt", "key", "nc")}
            plain = {k: batch[k].clone() for k in ("buf", "cnt", "key", "nc")}
            kll.kll_fold(card["buf"], card["cnt"], card["key"], card["nc"], chunks, valids, levels)
            kll.kll_fold_plain(plain["buf"], plain["cnt"], plain["key"], plain["nc"], chunks, valids, levels)
            compared += _same_leaves(f"raw chunks at capacity {capacity}, {'every level' if spread else 'level 0'}",
                                     card, plain)
            cases += 1
        merged = [batch, sk.kll_update(batch, torch.from_numpy(rng.random((BATCHED_SKETCHES, 9 * half + 5), np.float32)).to(DEVICE)), batch]
        compared += _same_leaves(f"8 merges at capacity {capacity}", sk.kll_merge(merged),
                                 _with_plain_fold(lambda: sk.kll_merge(merged)))
        small = sk.kll_init(capacity, seed=7, max_items=capacity * 15, device=DEVICE)  # 4 levels
        a = b = small
        for step in range(2):
            v = torch.from_numpy(np.round(rng.normal(size=capacity * 40 + 3), 2).astype(np.float32)).to(DEVICE)
            a = sk.kll_update(a, v)
            b = _with_plain_fold(lambda: sk.kll_update(b, v))
        compared += _same_leaves(f"the top level saturated at capacity {capacity}", a, b)
        if not float(sk.kll_total_weight(a)) < int(a["n"]):
            raise AssertionError(f"capacity {capacity}: the top level never compacted in place")
        cases += 2
    return compared, cases


def _kll_bound(chunks: int, compactions: int, levels: int, k: int) -> Tuple[float, str]:
    """The least time of a fold of ``chunks`` chunks with ``compactions`` compactions into one sketch of
    ``levels`` rows of ``k``: bytes, each chunk and its valid count and level read once, the state read
    and written once; operations, each compaction's K order keys and K binary searches of log2 K steps
    and its coin (a hash of 20 rounds of 3 operations), each chunk's K/2 slot writes and its key chain
    (3 such hashes)."""
    moved = chunks * (k // 2 * 4 + 8) + 2 * (levels * k * 4 + levels * 4 + 8 + 4)
    operations = compactions * (k * (1 + int(np.log2(k))) + 60) + chunks * (k // 2 + 3 * 60)
    return _bound(moved, operations)


def _kll_own(fn, levels: int, calls: int = 5) -> Optional[dict]:
    """The fold's own device time per call (every stage, profiler) and its plan stage's (the serial
    floor), each stage's, and its device operations per call: the median over sessions that saw the
    ``levels + 2`` operations a call makes (a session at times loses events, and once timed every
    operation of a session at half its length).  None where the profiler records no device activity."""
    sessions, most = [], []
    for _ in range(PROFILER_ATTEMPTS):
        seen = _device_ops(fn, calls)
        if seen is None:
            return None
        seen = [(op, ms) for op, ms in seen if "kll_fold" in op]
        most = max(most, seen, key=len)
        if len(seen) == calls * (levels + 2):
            sessions.append(seen)
    complete = bool(sessions)
    sessions = sessions or [most]  # every session lost events: the fullest one, marked
    stages: dict = {}
    for seen in sessions:
        for op, ms in seen:
            stage = next(name for name in ("kll_fold_plan", "kll_fold_execute", "kll_fold_assemble") if name in op)
            stages.setdefault(stage, []).append(ms)
    return {"ms": statistics.median(sum(ms for _, ms in seen) / calls for seen in sessions),
            "plan_ms": statistics.median(stages["kll_fold_plan"]),
            "stage_ms": {stage: sum(v) / (calls * len(sessions)) for stage, v in stages.items()},
            "ops_per_call": len(sessions[0]) / calls, "sessions": len(sessions), "complete": complete}


def _kll_event_ms(sk, state: dict, values: torch.Tensor) -> float:
    """The fold's device time per call by CUDA events (calls queued behind a sleep, the gaps between
    its launches included): the update's own ``kll_fold`` call, repeated in place on its copy of the
    state (each repeat folds the same chunks into a state as deep)."""
    from metrics_tpu_torch.ops import kll

    seen = []

    def capture(*args):
        seen.append(args)
        kll.kll_fold(*args)

    sk.kll_fold = capture
    try:
        sk.kll_update(state, values)
    finally:
        sk.kll_fold = kll.kll_fold
    return _device_ms(lambda: kll.kll_fold(*seen[0]), calls=20, warmup=2)[0]


def _short_op(name: str) -> str:
    """A device operation's name without its argument list and namespaces."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0].split("::")[-1][-60:] if "<" not in name else name[:60]


def _kll_timings(sk, err: torch.Tensor, deep: dict, last: torch.Tensor, deep_plain_ms: dict) -> dict:
    """The fold's own device time (profiler) on one main-path update at each capacity, from the deep
    state of (b), and its plan stage's; the device operations of one such update by name; the bound at
    those shapes; and the 300-chunk NYU prefix from empty beside the plain version."""
    prefix = err[: PREFIX_CHUNKS * SKETCH_CAPACITY // 2]
    empty = sk.kll_init(SKETCH_CAPACITY, max_items=SKETCH_MAX_ITEMS, device=DEVICE)
    out: dict = {"main_path": {}}
    for name, (before, after) in deep.items():
        levels, k = before["buf"].shape
        own = _kll_own(lambda: sk.kll_update(before, last), levels)
        event_ms = _kll_event_ms(sk, before, last)
        ops = _device_ops(lambda: sk.kll_update(before, last)) or []
        chunks = last.numel() // (k // 2)
        compactions = int(after["nc"]) - int(before["nc"])
        bound_ms, bound_by = _kll_bound(chunks, compactions, levels, k)
        out["main_path"][name] = {
            "capacity": k, "levels": levels, "chunks": chunks, "compactions": compactions,
            "ms": event_ms, "own_ms": own["ms"] if own else None, "plan_ms": own["plan_ms"] if own else None,
            "stage_ms": own["stage_ms"] if own else None, "kll_ops_per_call": own["ops_per_call"] if own else None,
            "plain_ms": deep_plain_ms[name], "bound_ms": bound_ms, "bound_by": bound_by,
            "update_device_ops": [(_short_op(op), ms) for op, ms in ops],
            "update_call_ms": _call_ms(lambda: sk.kll_update(before, last), reps=10, warmup=2),
        }
        m = out["main_path"][name]
        print(f"kll_fold, one main-path update of the {name} (capacity {k}, {levels} levels, {chunks} chunks, "
              f"{compactions} compactions, from the deep state of (b)): {m['ms']!r} ms of device time a call "
              f"(events), its operations' own {m['own_ms']!r} ms ({m['kll_ops_per_call']!r} a call; stages "
              f"{m['stage_ms']!r}), the plan stage "
              f"{m['plan_ms']!r} ms, bound {bound_ms!r} ms ({bound_by}), plain version {m['plain_ms']!r} ms; the "
              f"update {m['update_call_ms']!r} ms on an idle card, {len(ops)} device operations: {m['update_device_ops']!r}")
    levels, k = empty["buf"].shape
    own = _kll_own(lambda: sk.kll_update(empty, prefix), levels)
    prefix_ms = own["ms"] if own else None
    call_ms = _call_ms(lambda: sk.kll_update(empty, prefix), reps=10, warmup=2)
    plain_times = []
    for _ in range(3):
        torch.cuda.synchronize()
        start = time.perf_counter()
        _with_plain_fold(lambda: sk.kll_update(empty, prefix))
        torch.cuda.synchronize()
        plain_times.append((time.perf_counter() - start) * 1e3)
    folded = sk.kll_update(empty, prefix)
    chunks, compactions = PREFIX_CHUNKS, int(folded["nc"])
    bound_ms, bound_by = _kll_bound(chunks, compactions, levels, k)
    per_chunk_us = prefix_ms / chunks * 1e3 if prefix_ms else None
    print(f"kll_fold on the NYU prefix ({chunks} chunks of {k // 2} at capacity {k}, {compactions} compactions): "
          f"its own device time {prefix_ms!r} ms ({per_chunk_us!r} us per chunk; plan stage "
          f"{own['plan_ms'] if own else None!r} ms), one call on an idle card {call_ms!r} ms, plain version "
          f"{plain_times!r} ms, bound {bound_ms!r} ms ({bound_by})")
    out.update({"prefix_ms": prefix_ms, "prefix_plan_ms": own["plan_ms"] if own else None,
                "per_chunk_us": per_chunk_us, "call_ms": call_ms, "plain_ms": statistics.median(plain_times),
                "bound_ms": bound_ms, "bound_by": bound_by, "prefix_compactions": compactions})
    return out


def _window_reference_ok(name: str, got, want_num: int, want_den: int) -> None:
    want = np.float32(want_num) / np.float32(want_den)
    if got.dtype != torch.float32 or got.cpu().numpy().tobytes() != np.float32(want).tobytes():
        raise AssertionError(f"{name}: {float(got)!r}, numpy's integer counts give {want!r}")


def _phase_windows(mt, ops, kll, checks: dict) -> Tuple[dict, dict, dict]:
    """(c) the windows: rolling top-1 and p99 cross-entropy over the ImageNet pass, and a time-decayed
    MSE over the MovieLens-shaped pass, each against numpy.  Returns launches, kll launches and timings."""
    logits, labels, batches = _imagenet_pass()
    correct = (logits.argmax(dim=1) == labels).cpu().numpy()
    ce = (torch.logsumexp(logits, dim=1) - logits.gather(1, labels[:, None])[:, 0]).contiguous()
    ce_host = ce.cpu().numpy()
    acc = mt.WindowedMetric(mt.Accuracy(num_classes=N_CLASSES, device=DEVICE), window_size=ACC_WINDOW, device=DEVICE)
    p99 = mt.WindowedMetric(mt.StreamingQuantile(q=0.99, device=DEVICE), window_size=CE_WINDOW, device=DEVICE)
    bucket_rows: list = []  # the sample rows of each bucket, oldest first
    acc_values, p99_errors, evicted = [], [], 0
    for fn in (*_counters(ops).values(), kll.kll_fold):
        fn.launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    updates = computes = 0
    for epoch in range(WINDOW_EPOCHS):
        for b, (x, y) in enumerate(batches):
            rows = np.arange(b * BATCH, b * BATCH + x.shape[0])
            acc.update(x, y)
            p99.update(ce[rows[0] : rows[-1] + 1])
            updates += 1
            if not bucket_rows or updates % WINDOW_BUCKET == 1:
                bucket_rows.append(rows)
            else:
                bucket_rows[-1] = np.concatenate([bucket_rows[-1], rows])
            if updates % WINDOW_BUCKET:
                continue
            live = np.concatenate(bucket_rows[-ACC_WINDOW:])
            _window_reference_ok(f"window top-1 after update {updates}", acc.compute(), int(correct[live].sum()), live.size)
            acc_values.append(float(acc.compute()))
            ce_live = ce_host[np.concatenate(bucket_rows[-CE_WINDOW:])]
            est = p99.compute()
            computes += 1
            err_q = _rank_errors(np.array([float(est)], np.float32), [0.99], np.sort(ce_live))[0]
            bound = mt.kll_rank_error_bound(ce_live.size, mt.DEFAULT_CAPACITY)
            p99_errors.append(err_q)
            if err_q > bound:
                raise AssertionError(f"window p99 after update {updates}: rank error {err_q!r} over its bound {bound!r}")
            evicted += (acc.advance() > 0) + (p99.advance() > 0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    launches = {route: fn.launches for route, fn in _counters(ops).items()}
    kll_launches = kll.kll_fold.launches
    implied = {"logits": updates, "canonical": 0}
    print(f"windows: {updates} updates, {computes} computes, {evicted} evictions in {secs:.2f} s; stat-scores launches "
          f"{launches} (updates imply {implied}); kll_fold launches {kll_launches} (updates and compute merges imply "
          f"{updates + computes})")
    if launches != implied or kll_launches != updates + computes or not evicted:
        raise AssertionError("windows: the launches are not what the updates and computes imply, or nothing was evicted")
    checks["(c) window top-1"] = {"windows": len(acc_values), "bitwise": True, "last": acc_values[-1]}
    checks["(c) window p99 cross-entropy"] = {"windows": len(p99_errors), "worst_rank_error": max(p99_errors)}
    print(f"check windows: {len(acc_values)} rolling top-1 values bitwise equal to numpy's integer counts; "
          f"{len(p99_errors)} rolling p99 cross-entropies, worst rank error {max(p99_errors)!r}")

    preds, target, _ = _movielens_pass()
    ema = mt.TimeDecayedMetric(mt.MeanSquaredError(device=DEVICE), half_life=ML_HALF_LIFE, device=DEVICE)
    ml_batches = _batched(preds, target, ML_BATCH)
    for p, t in ml_batches:
        ema.update(p, t)
    p_host, t_host = preds.cpu().numpy().astype(np.float64), target.cpu().numpy().astype(np.float64)
    decay = 0.5 ** (1.0 / ML_HALF_LIFE)
    num = den = 0.0
    for i in range(0, p_host.size, ML_BATCH):
        num = num * decay + np.mean((p_host[i : i + ML_BATCH] - t_host[i : i + ML_BATCH]) ** 2)
        den = den * decay + 1.0
    # each batch's float32 MSE within SUM_DEPTH roundings, then two roundings per update of each EMA sum
    rtol = (SUM_DEPTH + 2 + 4 * len(ml_batches)) * U32
    _check_bound("(c) time-decayed MSE", ema.compute(), num / den, rtol * num / den, checks, "streaming")
    return launches, {"kll": kll_launches}, {"windows_s": secs, "window_updates": updates, "window_computes": computes,
                                               "evictions": evicted}


def _rank_streaming(mt, rank: int, out: Path) -> None:
    """This rank's share of the NYU stream into a StreamingQuantile and a ring of them, then each synced
    through the packed blob and leaf by leaf."""
    from metrics_tpu_torch.ops import kll
    from metrics_tpu_torch.parallel import DistBackend

    class PerLeaf(DistBackend):
        supports_packed = False

    first, stop = STREAM_SYNC_SHARDS[rank]
    mine = _stream_batches(_absrel_stream())[first:stop]
    q = mt.StreamingQuantile(q=SKETCH_Q, capacity=SKETCH_CAPACITY, max_items=SKETCH_MAX_ITEMS, device=DEVICE)
    ring = mt.WindowedMetric(mt.StreamingQuantile(q=0.99, capacity=SKETCH_CAPACITY, max_items=SKETCH_MAX_ITEMS,
                                                  device=DEVICE), window_size=RING_WINDOW, device=DEVICE)
    advance_at = {len(mine) * (m + 1) // (RING_ADVANCES + 1) - 1 for m in range(RING_ADVANCES)}
    for i, x in enumerate(mine):
        q.update(x)
        ring.update(x)
        if i in advance_at:
            ring.advance()
    leaves = {f"local.q.{k}": v for k, v in q.sketch_tree("sketch").items()}
    leaves.update({f"local.ring.{k}": v for k, v in ring.sketch_tree("wb_sketch").items()})
    kll.kll_fold.launches = 0
    report = {}
    for path, backend in (("packed", None), ("pure", PerLeaf())):
        torch.cuda.synchronize()
        start = time.perf_counter()
        with q.sync_context(backend=backend):
            torch.cuda.synchronize()
            report[f"{path}_ms"] = (time.perf_counter() - start) * 1e3
            leaves.update({f"{path}.q.{k}": v for k, v in q.sketch_tree("sketch").items()})
        report[f"{path}_bytes"] = q.last_sync_report["bytes_gathered"]
        with ring.sync_context(backend=backend):
            leaves.update({f"{path}.ring.{k}": v for k, v in ring.sketch_tree("wb_sketch").items()})
    report["sync_launches"] = kll.kll_fold.launches
    report["estimates"] = q.compute().cpu().tolist()
    report["local"] = not q._is_synced and all(
        torch.equal(v.view(torch.int32) if v.dtype == torch.uint32 else v,
                    leaves[f"local.q.{k}"].view(torch.int32) if v.dtype == torch.uint32 else leaves[f"local.q.{k}"])
        for k, v in q.sketch_tree("sketch").items())
    np.savez(out / f"rank{rank}.npz", **{k: v.cpu().numpy() for k, v in leaves.items()})
    (out / f"rank{rank}.json").write_text(json.dumps(report))


def phase_stream_sync(sk, data: np.ndarray) -> dict:
    """Two ranks on ``cuda:0`` fold uneven shares of the NYU stream and sync: both paths, both ranks, bitwise
    equal to each other and to this process's ``kll_merge`` of the two ranks' local states."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_streaming_") as tmp:
        where = Path(tmp) / "streaming"
        start = time.perf_counter()
        seen = _wait_ranks("streaming", _start_ranks("streaming", where), where)
        took = time.perf_counter() - start
        got = [dict(np.load(where / f"rank{rank}.npz")) for rank in range(SYNC_WORLD)]

    def tree(rank_leaves: dict, prefix: str) -> dict:
        return {k[len(prefix):]: torch.from_numpy(v).to(DEVICE) for k, v in rank_leaves.items() if k.startswith(prefix)}

    want_q = sk.kll_merge([tree(g, "local.q.") for g in got])
    want_ring = sk.kll_merge([tree(g, "local.ring.") for g in got])
    for rank, g in enumerate(got):
        for path in ("packed", "pure"):
            _same_leaves(f"sync rank {rank} {path} quantile sketch", tree(g, f"{path}.q."), want_q)
            _same_leaves(f"sync rank {rank} {path} ring", tree(g, f"{path}.ring."), want_ring)
        if not seen[rank]["local"]:
            raise AssertionError(f"sync rank {rank}: the local sketch did not come back after compute()")
        if seen[rank]["sync_launches"] != 4:
            raise AssertionError(f"sync rank {rank}: {seen[rank]['sync_launches']} kll_fold launches for two syncs of a "
                                 "sketch and two of a ring, not one each")
    if seen[0]["estimates"] != seen[1]["estimates"]:
        raise AssertionError("sync: the ranks' estimates differ")
    n = int(want_q["n"])
    eps = sk.kll_rank_error_bound(n, SKETCH_CAPACITY)
    errs = _rank_errors(np.array(seen[0]["estimates"], np.float32), SKETCH_Q, data)
    if n != data.size or errs.max() > eps:
        raise AssertionError(f"sync: merged estimates' rank errors {errs!r} over the bound {eps!r} (n {n})")
    print(f"check streaming sync: both ranks, packed and leaf by leaf, bitwise equal to kll_merge of the two local "
          f"sketches and rings ({took:.1f} s with start-up); estimates' rank errors {errs.tolist()!r} (bound {eps!r}); "
          f"sync ms per rank {[(s['packed_ms'], s['pure_ms']) for s in seen]!r}, bytes gathered "
          f"{[(s['packed_bytes'], s['pure_bytes']) for s in seen]!r}, one kll_fold launch per merge")
    return {"ranks_s": took, "rank_errors": errs.tolist(), "sync_ms_per_rank": [[s["packed_ms"], s["pure_ms"]] for s in seen],
            "bytes_gathered_per_rank": [[s["packed_bytes"], s["pure_bytes"]] for s in seen],
            "kll_launches_per_rank": [s["sync_launches"] for s in seen]}


def phase_streaming(mt, ops, card: str) -> Tuple[dict, dict, dict]:
    """(a) per-pixel error quantiles and a histogram over the NYU-Depth pass, (b) the kernel against its
    plain version, (c) windows and a time-decayed metric, (d) a two-rank sketch sync; each against numpy.
    Returns the stat-scores launches, the kll_fold entry of the kernels line, and the streaming line."""
    from metrics_tpu_torch.ops import kll
    from metrics_tpu_torch.streaming import sketches as sk

    phase_start = time.perf_counter()
    checks, passes = {}, {}
    err = _absrel_stream()
    batches = _stream_batches(err)
    n = err.numel()

    # (a) the main path: every batch into the quantiles and the histogram
    q = mt.StreamingQuantile(q=SKETCH_Q, capacity=SKETCH_CAPACITY, max_items=SKETCH_MAX_ITEMS, device=DEVICE)
    hist = mt.StreamingHistogram(bins=HIST_BINS, max_items=SKETCH_MAX_ITEMS, device=DEVICE)
    launches_main = 0
    results, deep = {}, {}  # deep: each sketch around its launch on the stream's last full batch, for (b)
    deep_at = len(batches) - 2  # the last batch holds 6 maps; the one before it is 8 maps into a deep state
    for name, metric in (("quantile", q), ("histogram", hist)):
        kll.kll_fold.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start = time.perf_counter()
        for i, x in enumerate(batches):
            if i == deep_at:
                before = {k: v.clone() for k, v in metric.sketch_tree("sketch").items()}
            metric.update(x)
            if i == deep_at:
                deep[name] = (before, {k: v.clone() for k, v in metric.sketch_tree("sketch").items()})
        results[name] = metric.compute()
        torch.cuda.synchronize()
        secs = time.perf_counter() - start
        launches = kll.kll_fold.launches
        launches_main += launches
        tree = metric.sketch_tree("sketch")
        levels, capacity = tree["buf"].shape
        passes[f"(a) {name}"] = {
            "values_per_s": n / secs, "values": n, "batches": len(batches), "capacity": capacity, "levels": levels,
            "chunks": sum(-(-x.numel() // (capacity // 2)) for x in batches), "compactions": int(tree["nc"]),
            "launches": launches, "peak_bytes": torch.cuda.max_memory_allocated() - base, "secs": secs,
        }
        print(f"streaming (a) {name}: {passes[f'(a) {name}']!r}")
        if launches != len(batches) or int(tree["n"]) != n:
            raise AssertionError(f"{name}: {launches} kll_fold launches for {len(batches)} updates, n {int(tree['n'])} of {n}")
    data = np.sort(err.cpu().numpy())  # the exact ranks of every check below come from one sort on the host
    eps_q = sk.kll_rank_error_bound(n, SKETCH_CAPACITY)
    errs = _rank_errors(results["quantile"].cpu().numpy(), SKETCH_Q, data)
    checks["(a) quantiles"] = {"estimates": results["quantile"].cpu().tolist(), "rank_errors": errs.tolist(), "bound": eps_q}
    print(f"check streaming quantiles {SKETCH_Q}: estimates {results['quantile'].cpu().tolist()!r}, normalized rank "
          f"errors against the exact ranks {errs.tolist()!r} (bound {eps_q!r})")
    if errs.max() > eps_q:
        raise AssertionError("streaming quantiles outside the sketch's rank-error bound")
    _histogram_check(results["histogram"], data, sk.kll_rank_error_bound(n, mt.DEFAULT_CAPACITY), checks)
    updates = _member_timings({
        "StreamingQuantile (capacity 2048)": (mt.StreamingQuantile(q=SKETCH_Q, capacity=SKETCH_CAPACITY,
                                                                   max_items=SKETCH_MAX_ITEMS, device=DEVICE), (batches[0],)),
        "StreamingHistogram (capacity 256)": (mt.StreamingHistogram(bins=HIST_BINS, max_items=SKETCH_MAX_ITEMS,
                                                                    device=DEVICE), (batches[0],)),
    })

    # (b) the kernel against its plain version
    compared = _card_vs_plain_sketches(sk, err, batches[deep_at], deep)
    timing = _kll_timings(sk, err, deep, batches[deep_at], compared["deep_plain_ms"])

    # (c) windows
    del batches
    stat_launches, kll_c, window_info = _phase_windows(mt, ops, kll, checks)
    passes["(c) windows"] = window_info

    # (d) the sketch sync over two ranks
    del err
    torch.cuda.empty_cache()
    sync = phase_stream_sync(sk, data)

    secs = time.perf_counter() - phase_start
    print(f"streaming phase took {secs:.1f} s")
    quantile, histogram = timing["main_path"]["quantile"], timing["main_path"]["histogram"]
    entry = {
        "name": "kll_fold",
        "route": "cuda",
        "source": "metrics_tpu_torch/ops/csrc/kll_fold.cu",
        "replaces": "metrics_tpu/streaming/sketches.py:128",
        "replaces_kind": "_fold_chunks, a lax.scan formulation (not a Pallas kernel)",
        "launches": launches_main + kll_c["kll"],
        "bitwise": True,
        "max_abs_err": 0,
        # the device time of a call (every stage, by events) on the main path's update at capacity 2048,
        # from the deep state of (b); beside it its operations' own time (profiler) and the plan stage's
        "ms": quantile["ms"],
        "own_ms": quantile["own_ms"],
        "ms_shape": f"one main-path update: {quantile['chunks']} chunks of {SKETCH_CAPACITY // 2} at capacity "
                    f"{SKETCH_CAPACITY} into a deep state",
        "plan_ms": quantile["plan_ms"],
        "device_ops_per_call": quantile["kll_ops_per_call"],
        "plain_ms": quantile["plain_ms"],
        "bound_ms": quantile["bound_ms"],
        "bound_by": quantile["bound_by"],
        "capacity_256": {key: histogram[key] for key in ("chunks", "ms", "own_ms", "plan_ms", "plain_ms", "bound_ms",
                                                         "bound_by")},
        "prefix": {"shape": f"{PREFIX_CHUNKS} chunks at capacity {SKETCH_CAPACITY}, from empty",
                   "ms": timing["prefix_ms"], "plan_ms": timing["prefix_plan_ms"], "per_chunk_us": timing["per_chunk_us"],
                   "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"]},
        "library_ms": None,
        "library_note": "no PyTorch call folds chunks into a KLL sketch",
    }
    line = {"streaming": {
        "card": card, "passes": passes, "updates": updates, "checks": checks, "card_vs_plain": compared,
        "kll_timing": timing, "sync": sync, "launches": {**stat_launches, "kll_fold": entry["launches"]}, "phase_s": secs,
    }}
    return stat_launches, entry, line


# ---------------------------------------------------------------- phase 12: checkpoint and multistream

MS_SOURCES = 64  # (a) F1's streams: source ids drawn from the seed
ML_USERS = 162_541  # MovieLens-25M's users: (b)'s streams
ML_USER_TAIL = 3.0  # (b)'s user ids: floor(users x u^3), u uniform: a heavy head of frequent raters
MS_QUANTILES = (0.5, 0.9, 0.99)
MS_COMPUTE_STREAMS = 1000  # ids of (b)'s compute_streams query
MS_TIMING_STREAMS = 64  # S of the per-stream entry points' timed calls at (1024, 1000)
# S of the card's large-S cases: 600 past the 402 streams one block of the canonical route holds for bool
# operands at C = 1000 (8-byte loads), 5000 past the 664 it holds for int32; 600 x 1000 outputs also loop the
# logits route's ranges past two blocks an SM times 2048
MS_LARGE_STREAMS = (600, 5000)
MS_BINS = 20  # (c)'s per-class histogram
MS_SYNC_SPLIT = 2  # the two-rank checkpoint: rank r takes every other batch, from batch r
# (b)'s per-user sums: each of a user's n terms rounds once (a difference, then its square or abs), the float32
# sum adds n roundings of at most the running sum, the mean one more: all terms are >= 0, so the value lies
# within (n + 4) x 2^-24 of the float64 reference, relative.  A two-rank fold adds one rounding more.
ML_UNITS_PAST_ROWS = 4


def _ms_sources() -> torch.Tensor:
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    return torch.randint(0, MS_SOURCES, (N_SAMPLES,), generator=gen, device=DEVICE)


def _ml_users() -> torch.Tensor:
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 21)
    u = torch.rand(ML_RATINGS, generator=gen, device=DEVICE, dtype=torch.float64)
    return (ML_USERS * u**ML_USER_TAIL).floor().to(torch.int64).clamp_(max=ML_USERS - 1)


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample cross-entropy of the logits, float32, on the card."""
    return torch.logsumexp(logits, 1) - logits.gather(1, labels[:, None])[:, 0]


def _ms_metrics(mt, device: str = DEVICE) -> dict:
    """Phase 12's metrics: (a) per-class accuracy, per-source F1 and per-class top-5 accuracy, (b) per-user
    MSE and MAE, (c) per-class cross-entropy quantiles and histograms, and configuration 2 (not stacked)."""
    ms = mt.MultiStreamMetric
    return {
        "acc": ms(mt.Accuracy(num_classes=N_CLASSES, device=device), num_streams=N_CLASSES, device=device),
        "f1": ms(mt.F1Score(num_classes=N_CLASSES, average="macro", device=device), num_streams=MS_SOURCES, device=device),
        "top5": ms(mt.Accuracy(num_classes=N_CLASSES, top_k=TOP_K, device=device), num_streams=N_CLASSES, device=device),
        "mse": ms(mt.MeanSquaredError(device=device), num_streams=ML_USERS, device=device),
        "mae": ms(mt.MeanAbsoluteError(device=device), num_streams=ML_USERS, device=device),
        "q": ms(mt.StreamingQuantile(q=MS_QUANTILES, device=device), num_streams=N_CLASSES, device=device),
        "h": ms(mt.StreamingHistogram(bins=MS_BINS, device=device), num_streams=N_CLASSES, device=device),
        "config2": mt.MetricCollection(
            {"acc": mt.Accuracy(num_classes=N_CLASSES, average="macro", device=device),
             "f1": mt.F1Score(num_classes=N_CLASSES, average="macro", device=device),
             "prec": mt.Precision(num_classes=N_CLASSES, average="macro", device=device),
             "cm": mt.ConfusionMatrix(num_classes=N_CLASSES, device=device)},
            device=device,
        ),
    }


def _ms_feeds(logits, labels, sources, ce, ml_preds, ml_target, users) -> dict:
    """Each metric's batches as (args, kwargs) on the card: ImageNet batches of 1024, MovieLens batches of 65,536."""
    image = range(0, N_SAMPLES, BATCH)
    ratings = range(0, ML_RATINGS, ML_BATCH)
    return {
        "acc": [((logits[i : i + BATCH], labels[i : i + BATCH]), {"stream_ids": labels[i : i + BATCH]}) for i in image],
        "f1": [((logits[i : i + BATCH], labels[i : i + BATCH]), {"stream_ids": sources[i : i + BATCH]}) for i in image],
        "top5": [((logits[i : i + BATCH], labels[i : i + BATCH]), {"stream_ids": labels[i : i + BATCH]}) for i in image],
        "mse": [((ml_preds[i : i + ML_BATCH], ml_target[i : i + ML_BATCH]), {"stream_ids": users[i : i + ML_BATCH]}) for i in ratings],
        "mae": [((ml_preds[i : i + ML_BATCH], ml_target[i : i + ML_BATCH]), {"stream_ids": users[i : i + ML_BATCH]}) for i in ratings],
        "q": [((ce[i : i + BATCH],), {"stream_ids": labels[i : i + BATCH]}) for i in image],
        "h": [((ce[i : i + BATCH],), {"stream_ids": labels[i : i + BATCH]}) for i in image],
        "config2": [((logits[i : i + BATCH], labels[i : i + BATCH]), {}) for i in image],
    }


def _ms_data():
    logits, labels, _ = _imagenet_pass()
    ml_preds, ml_target, _ = _movielens_pass()
    return logits, labels, _ms_sources(), _cross_entropy(logits, labels), ml_preds, ml_target, _ml_users()


def _states_of(target) -> dict:
    """Every state of a metric or collection, on the host, by flat checkpoint key."""
    from metrics_tpu_torch.checkpoint import flatten_target

    out = {}
    for key, m in flatten_target(target).items():
        for name, v in m.state_pytree().items():
            out[f"{key}.{name}"] = v.detach().cpu().clone() if isinstance(v, torch.Tensor) else torch.tensor(v)
    return out


def _same_states(name: str, a: dict, b: dict) -> int:
    if sorted(a) != sorted(b):
        raise AssertionError(f"{name}: states {sorted(a)} and {sorted(b)}")
    for k in a:
        x, y = a[k], b[k]
        x = x.view(torch.int32) if x.dtype == torch.uint32 else x
        y = y.view(torch.int32) if y.dtype == torch.uint32 else y
        if x.dtype != y.dtype or x.shape != y.shape or x.numpy().tobytes() != y.numpy().tobytes():
            raise AssertionError(f"{name}: state {k!r} differs")
    return len(a)


def _ms_counters(ops, kll) -> dict:
    return {"stream_logits": ops.fused_stream_stat_scores_logits, "stream_canonical": ops.fused_stream_stat_scores,
            "logits": ops.fused_stat_scores_logits, "canonical": ops.fused_stat_scores, "kll_fold": kll.kll_fold}


def _ms_ranking(values: np.ndarray, k: int, largest: bool) -> np.ndarray:
    """numpy's ranking of float32 scores as top_k ranks them: NaN last, ties to the lower stream id."""
    if largest:
        return np.argsort(-np.where(np.isnan(values), -np.inf, values), kind="stable")[:k]
    return np.argsort(np.where(np.isnan(values), np.inf, values), kind="stable")[:k]


def _check_ranking(name: str, metric, values: np.ndarray, k: int, largest: bool) -> None:
    got_v, got_i = metric.top_k(k, largest=largest)
    want = _ms_ranking(values, k, largest)
    if got_i.cpu().numpy().astype(np.int64).tolist() != want.tolist() or got_v.cpu().numpy().tobytes() != values[want].tobytes():
        raise AssertionError(f"{name} {'top' if largest else 'bottom'}_k({k}): {got_i.tolist()} against numpy's {want.tolist()}")


def _stream_counts_np(pred: np.ndarray, label: np.ndarray, ids: np.ndarray, s: int, c: int, micro: bool) -> dict:
    """numpy's per-stream tp/fp/tn/fn of top-1 predictions (or, with `pred` (N, k), top-k) against labels."""
    rows = np.bincount(ids, minlength=s).astype(np.int64)
    if pred.ndim == 1:
        hit = pred == label
        if micro:
            tp = np.bincount(ids, weights=hit, minlength=s).astype(np.int64)
            fp = rows - tp
            fn = rows - tp
            return {"tp": tp, "fp": fp, "fn": fn, "tn": c * rows - tp - fp - fn}
        tp = np.bincount(ids * c + pred, weights=hit, minlength=s * c).astype(np.int64).reshape(s, c)
        pc = np.bincount(ids * c + pred, minlength=s * c).astype(np.int64).reshape(s, c)
        lc = np.bincount(ids * c + label, minlength=s * c).astype(np.int64).reshape(s, c)
        return {"tp": tp, "fp": pc - tp, "fn": lc - tp, "tn": rows[:, None] - pc - lc + tp}
    k = pred.shape[1]
    hit = (pred == label[:, None]).any(1)
    tp = np.bincount(ids, weights=hit, minlength=s).astype(np.int64)
    fp = k * rows - tp
    fn = rows - tp
    return {"tp": tp, "fp": fp, "fn": fn, "tn": c * rows - tp - fp - fn}


def _f1_macro_np(counts: dict) -> np.ndarray:
    tp, fp, fn = (counts[k].astype(np.float64) for k in ("tp", "fp", "fn"))
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.where(tp + fp > 0, tp / (tp + fp), 0.0)
        r = np.where(tp + fn > 0, tp / (tp + fn), 0.0)
        f = np.where(p + r > 0, 2 * p * r / (p + r), 0.0)
    present = (tp + fp + fn) > 0
    return (f * present).sum(1) / present.sum(1)


def _check_ms_counts(name: str, metric, want: dict) -> int:
    for k, v in want.items():
        got = getattr(metric, k).cpu().numpy()
        if got.dtype != np.int32 or got.astype(np.int64).tobytes() != v.astype(np.int64).tobytes():
            raise AssertionError(f"{name}: {k} differs from numpy's per-stream counts")
    return len(want)


def _check_rel(name: str, got: np.ndarray, want: np.ndarray, rel: np.ndarray, checks: dict) -> None:
    both = ~np.isnan(want)
    if (np.isnan(got) != np.isnan(want)).any():
        raise AssertionError(f"{name}: NaN where numpy has a value, or the other way")
    err = np.abs(got[both].astype(np.float64) - want[both]) / np.maximum(np.abs(want[both]), np.finfo(np.float64).tiny)
    worst = float((err / rel[both]).max()) if both.any() else 0.0
    checks[name] = {"worst_share_of_bound": worst, "streams": int(both.sum())}
    print(f"check {name}: {int(both.sum())} streams within their bound, worst {worst!r} of it")
    if worst > 1.0:
        raise AssertionError(f"{name}: a stream's value lies outside its bound")


def _staged_rows(ids: np.ndarray, m: int) -> np.ndarray:
    """Which rows of one batch the vmap strategy stages: each stream's first m rows (stable order)."""
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    pos = np.arange(ids.size) - np.searchsorted(sorted_ids, sorted_ids, side="left")
    keep = np.zeros(ids.size, bool)
    keep[order[pos < m]] = True
    return keep


def _ms_card_vs_plain(ops, mt, first_batch) -> int:
    """The per-stream entry points against their plain versions on the main-path batch and edge cases,
    bitwise; num_valid through the metric on the card against the metric on the CPU."""
    compared = 0
    x, y, src = first_batch

    def same(case, got, want):
        nonlocal compared
        for which, g, w in zip(COUNTS, got, want):
            if g.dtype != torch.int32 or not torch.equal(g.cpu(), w.cpu()):
                raise AssertionError(f"per-stream {which} differs from the plain version on {case}")
        compared += 1

    cases = [("main-path batch, ids = labels, S = 1000", x, y, y, N_CLASSES),
             ("main-path batch, 64 sources", x, y, src, MS_SOURCES)]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 22)
    s = MS_SOURCES
    cases.append(("ids out of range on both sides", x, y, torch.randint(-3, s + 3, (x.shape[0],), generator=gen, device=DEVICE), s))
    cases.append(("S = 1", x, y, torch.zeros_like(y), 1))
    cases.append(("all rows in one stream", x, y, torch.full_like(y, 7), s))
    cases.append(("N = 0", x[:0], y[:0], y[:0], s))
    for dtype in LOGIT_DTYPES:
        logits, labels = _logit_cases(BATCH, N_CLASSES, dtype, torch.int64, seed=SEED + 23)
        cases.append((f"NaN, tied and infinite {str(dtype).replace('torch.', '')} logits", logits, labels, labels % s, s))
    for case, logits, labels, ids, s in cases:
        for micro in (False, True):
            same(f"{case}, micro={micro}", ops.fused_stream_stat_scores_logits(logits, labels, ids, s, micro),
                 ops.fused_stream_stat_scores_logits_plain(logits, labels, ids, s, micro))
            for dtype in (torch.int32, torch.bool):
                top = torch.zeros_like(logits, dtype=dtype).scatter_(1, logits.float().nan_to_num(-1e30).topk(TOP_K, 1).indices, 1)
                hot = torch.zeros_like(logits, dtype=dtype).scatter_(1, labels.clamp(0, logits.shape[1] - 1)[:, None], 1)
                same(f"{case}, canonical {str(dtype).replace('torch.', '')}, micro={micro}",
                     ops.fused_stream_stat_scores(top, hot, ids, s, micro), ops.fused_stream_stat_scores_plain(top, hot, ids, s, micro))
    # the large-S branch of the canonical route (S past the streams a block's shared memory holds) and logits
    # ranges that loop (S * C past two blocks an SM times 2048 outputs), on random 0/1 operands; then
    # C = 1, C = 9 with S = 1, int32 ids and labels, and canonical values outside {0, 1}
    n = x.shape[0]
    for s in MS_LARGE_STREAMS:
        ids = torch.randint(-3, s + 3, (n,), generator=gen, device=DEVICE)
        for dtype in (torch.int32, torch.bool):
            a = torch.randint(0, 2, x.shape, generator=gen, device=DEVICE).to(dtype)
            b = torch.randint(0, 2, x.shape, generator=gen, device=DEVICE).to(dtype)
            for micro in (False, True):
                same(f"large S = {s}, random 0/1 {str(dtype).replace('torch.', '')}, micro={micro}",
                     ops.fused_stream_stat_scores(a, b, ids, s, micro), ops.fused_stream_stat_scores_plain(a, b, ids, s, micro))
        for micro in (False, True):
            same(f"logits, S = {s}, micro={micro}", ops.fused_stream_stat_scores_logits(x, y, ids, s, micro),
                 ops.fused_stream_stat_scores_logits_plain(x, y, ids, s, micro))
    for c, s in ((1, 3), (9, 1), (37, 5)):
        logits, labels = _logit_cases(n, c, torch.float32, torch.int32, seed=SEED + 26 + c)
        ids = torch.randint(-2, s + 2, (n,), generator=gen, device=DEVICE, dtype=torch.int32)
        a = torch.randint(-2, 3, (n, c), generator=gen, device=DEVICE, dtype=torch.int32)
        b = torch.randint(-2, 3, (n, c), generator=gen, device=DEVICE, dtype=torch.int32)
        for micro in (False, True):
            same(f"C = {c}, S = {s}, int32 ids and labels, micro={micro}",
                 ops.fused_stream_stat_scores_logits(logits, labels, ids, s, micro),
                 ops.fused_stream_stat_scores_logits_plain(logits, labels, ids, s, micro))
            same(f"C = {c}, S = {s}, canonical values in [-2, 2], micro={micro}",
                 ops.fused_stream_stat_scores(a, b, ids, s, micro), ops.fused_stream_stat_scores_plain(a, b, ids, s, micro))
    for nv in (0, 700, 5000):  # rows past num_valid neither route nor count as dropped
        made = {d: mt.MultiStreamMetric(mt.Accuracy(num_classes=N_CLASSES, device=d), num_streams=MS_SOURCES, device=d) for d in (DEVICE, "cpu")}
        for d, m in made.items():
            m.update(x.to(d), y.to(d), stream_ids=src.to(d), num_valid=nv)
        _same_states(f"num_valid={nv}", _states_of(made[DEVICE]), _states_of(made["cpu"]))
        compared += 1
    print(f"check per-stream stat-scores entry points: {compared} cases bitwise against the plain version and the CPU")
    return compared


def _ms_entry(ops, logits: torch.Tensor, labels: torch.Tensor) -> list:
    """The kernels-line entries of the per-stream entry points, timed at (1024, 1000) with S = 64 on random
    operands (their launches are phase 12's, filled in after it runs), and at phase 12's own calls on its first
    batch: per-class accuracy (logits, micro, S = 1,000), per-source F1 (logits, S = 64) and per-class top-5
    accuracy (canonical int32 top-5 masks against one-hot labels, micro, S = 1,000).  Timed beside the other
    entry points, before the curve phase: torch.profiler sessions after it lose device events."""
    from metrics_tpu_torch.utils.data import select_topk, to_onehot

    n, c, s = BATCH, N_CLASSES, MS_TIMING_STREAMS
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 24)
    rand_logits = torch.randn((n, c), generator=gen, device=DEVICE)
    rand_labels = torch.randint(0, c, (n,), generator=gen, device=DEVICE)
    ids = torch.randint(0, s, (n,), generator=gen, device=DEVICE)
    preds = torch.randint(0, 2, (n, c), generator=gen, device=DEVICE, dtype=torch.int32)
    target = torch.randint(0, 2, (n, c), generator=gen, device=DEVICE, dtype=torch.int32)
    x, y, src = logits[:n], labels[:n], _ms_sources()[:n]
    top5, hot = select_topk(x, TOP_K), to_onehot(y, c)
    # each input read once, the four int32 outputs written once; about six integer operations an element
    logits_bytes = lambda width, streams: n * c * 4 + n * 8 + n * 8 + 4 * streams * width * 4  # noqa: E731
    canonical_bytes = lambda width, streams, item: 2 * n * c * item + n * 8 + 4 * streams * width * 4  # noqa: E731
    phase12 = {
        "stream_logits": [
            ("per-class accuracy, micro, S = 1000", lambda: ops.fused_stream_stat_scores_logits(x, y, y, c, True),
             lambda: ops.fused_stream_stat_scores_logits_plain(x, y, y, c, True), logits_bytes(1, c)),
            ("per-source F1, (S, C), S = 64", lambda: ops.fused_stream_stat_scores_logits(x, y, src, MS_SOURCES),
             lambda: ops.fused_stream_stat_scores_logits_plain(x, y, src, MS_SOURCES), logits_bytes(c, MS_SOURCES)),
        ],
        "stream_canonical": [
            ("per-class top-5 accuracy, micro, S = 1000", lambda: ops.fused_stream_stat_scores(top5, hot, y, c, True),
             lambda: ops.fused_stream_stat_scores_plain(top5, hot, y, c, True), canonical_bytes(1, c, top5.element_size())),
        ],
    }
    entries = []
    for name, kernel, plain, inputs_bytes, key in (
        ("stream_stat_scores_logits", lambda: ops.fused_stream_stat_scores_logits(rand_logits, rand_labels, ids, s),
         lambda: ops.fused_stream_stat_scores_logits_plain(rand_logits, rand_labels, ids, s), n * c * 4 + n * 8 + n * 8, "stream_logits"),
        ("stream_stat_scores", lambda: ops.fused_stream_stat_scores(preds, target, ids, s),
         lambda: ops.fused_stream_stat_scores_plain(preds, target, ids, s), 2 * n * c * 4 + n * 8, "stream_canonical"),
    ):
        own_ms = _one_launch(name, kernel)
        times = _in_turns({"plain": plain, "kernel": kernel}, ["plain", "kernel", "kernel", "plain"])
        bound_ms, bound_by = _bound(inputs_bytes + 4 * s * c * 4, 6 * n * c)
        micro = (lambda: ops.fused_stream_stat_scores_logits(rand_logits, rand_labels, ids, s, True)) if key == "stream_logits" \
            else (lambda: ops.fused_stream_stat_scores(preds, target, ids, s, True))
        micro_ms = _device_ms(micro)[0]
        micro_own_ms = _one_launch(f"{name} micro", micro)
        print(f"{name} at {(n, c)} with S = {s}: kernel {times['kernel']!r} ms (its own device time {own_ms!r} ms), "
              f"plain {times['plain']!r} ms, bound {bound_ms!r} ms ({bound_by}); micro (S,) outputs {micro_ms!r} ms "
              f"(own {micro_own_ms!r} ms)")
        calls = []
        for what, call, call_plain, call_bytes in phase12[key]:
            call_own = _one_launch(f"{name}, {what}", call)
            call_times = _in_turns({"plain": call_plain, "kernel": call}, ["plain", "kernel", "kernel", "plain"])
            call_bound, call_by = _bound(call_bytes, 6 * n * c)
            print(f"{name}, phase 12's {what}: kernel {call_times['kernel']!r} ms (own {call_own!r} ms), plain "
                  f"{call_times['plain']!r} ms, bound {call_bound!r} ms ({call_by})")
            calls.append({"call": what, "ms": call_times["kernel"], "kernel_ms": call_own, "plain_ms": call_times["plain"],
                          "bound_ms": call_bound, "bound_by": call_by})
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "metrics_tpu_torch/ops/csrc/stat_scores.cu",
            "replaces": "metrics_tpu/ops/stat_scores_pallas.py:124",
            "replaces_kind": "the per-row stat-scores update that metrics_tpu/multistream/core.py:361-378 "
                             "vmaps and segment-sums (the Pallas kernel under jax.vmap on a TPU)",
            "counter": key,
            "launches": 0,
            "bitwise": True,
            "max_abs_err": 0,
            "ms": times["kernel"],
            "kernel_ms": own_ms,
            "micro_ms": micro_ms,
            "micro_kernel_ms": micro_own_ms,
            "ms_shape": f"({n}, {c}) into S = {s} streams, (S, C) outputs, random operands",
            "plain_ms": times["plain"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "library_note": "no single PyTorch call computes per-stream counts (the plain version is an argmax or "
                            "one-hot chain and four index_add_ calls)",
            "phase12_calls": calls,
        })
    return entries


def _rank_checkpoint(mt, rank: int, out: Path) -> None:
    """This rank's share of the (a) and (b) batches, one checkpoint saved through the group's store, and the
    synced per-class accuracy."""
    from metrics_tpu_torch.checkpoint import CheckpointManager

    data = _ms_data()
    feeds = _ms_feeds(*data)
    full = _ms_metrics(mt)
    col = mt.MetricCollection({k: full[k] for k in ("acc", "f1", "mse")}, compute_groups=False, device=DEVICE)
    for key in col.keys():
        for args, kwargs in feeds[key][rank::MS_SYNC_SPLIT]:
            col[key].update(*args, **kwargs)
    manager = CheckpointManager(str(out / "ckpt"), barrier_timeout=SYNC_LIMIT)
    torch.cuda.synchronize()
    start = time.perf_counter()
    step = manager.save(col)
    save_ms = (time.perf_counter() - start) * 1e3
    acc = col["acc"].compute().cpu().numpy()
    np.save(out / f"acc{rank}.npy", acc)
    (out / f"rank{rank}.json").write_text(json.dumps({
        "step": step, "rank": manager.rank, "world": manager.world_size, "store": manager._kv_client() is not None,
        "save_ms": save_ms, "bytes": manager.store.bytes_written, "fsyncs": manager.store.fsyncs,
    }))


def phase_ms_sync(mt, full: dict, where: Path) -> dict:
    """Two gloo ranks save one checkpoint; it restores here at world size 1 (the elastic fold) against the
    single-process pass."""
    from metrics_tpu_torch.checkpoint import CheckpointManager

    ranks = _start_ranks("checkpoint", where)
    records = _wait_ranks("checkpoint", ranks, where)
    for rank, rec in enumerate(records):
        if rec is None or (rec["rank"], rec["world"], rec["store"], rec["step"]) != (rank, SYNC_WORLD, True, 0):
            raise AssertionError(f"checkpoint rank {rank} did not save step 0 through the group's store: {rec}")
    fresh = _ms_metrics(mt)
    col = mt.MetricCollection({k: fresh[k] for k in ("acc", "f1", "mse")}, compute_groups=False, device=DEVICE)
    torch.cuda.synchronize()
    start = time.perf_counter()
    result = CheckpointManager(str(where / "ckpt"), rank=0, world_size=1).restore(col)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - start) * 1e3
    if result.world_size != SYNC_WORLD or result.folded_shards != [1]:
        raise AssertionError(f"the elastic restore folded {result.folded_shards} of a world of {result.world_size}")
    single = {k: _states_of(full[k]) for k in ("acc", "f1", "mse")}
    folded = {k: _states_of(col[k]) for k in ("acc", "f1", "mse")}
    integers = 0
    for key in ("acc", "f1"):
        integers += _same_states(f"two-rank fold of {key}", single[key], folded[key])
    integers += _same_states("two-rank fold of mse's counts",
                             {k: v for k, v in single["mse"].items() if not k.endswith("sum_squared_error")},
                             {k: v for k, v in folded["mse"].items() if not k.endswith("sum_squared_error")})
    rows = single["mse"]["metric.stream_rows"].numpy().astype(np.float64)
    want = single["mse"]["metric.sum_squared_error"].numpy().astype(np.float64)
    got = folded["mse"]["metric.sum_squared_error"].numpy().astype(np.float64)
    # two float32 sums of a user's n nonnegative terms, each within n 2^-24 of its exact sum, and their rounded total
    bound = (2 * rows + 2) * 2.0**-24 * want
    worst = float(np.max(np.abs(got - want) - bound))
    if worst > 0:
        raise AssertionError("the two-rank fold's MSE sums lie outside their float32 bound")
    acc_single = full["acc"].compute().cpu().numpy()
    for rank in range(SYNC_WORLD):
        synced = np.load(where / f"acc{rank}.npy")
        if synced.tobytes() != acc_single.tobytes():
            raise AssertionError(f"rank {rank}'s synced per-class accuracy differs from one process's")
    record = {"save_ms": [r["save_ms"] for r in records], "bytes": [r["bytes"] for r in records],
              "fsyncs": [r["fsyncs"] for r in records], "restore_ms": restore_ms, "integer_states_bitwise": integers,
              "mse_sums_within_bound": True, "synced_accuracy_bitwise": True}
    print(f"check two-rank checkpoint: saved through the group's store by both ranks ({record['save_ms']} ms, "
          f"{record['bytes']} bytes, {record['fsyncs']} fsyncs), restored at world size 1 in {restore_ms!r} ms; "
          f"{integers} integer states bitwise, MSE sums within their bound, both ranks' synced accuracy bitwise")
    return record


def phase_multistream(mt, ops, card: str) -> Tuple[dict, dict, dict]:
    """(a) per-class and per-source classification streams through the per-stream kernel, (b) per-user
    MovieLens errors, (c) per-class quantiles and histograms, each through one kll_fold over 1,000 sketches an
    update, (d) checkpoints of all
    of it halfway, restored on the card and on the CPU, and over two ranks.  Returns the stat-scores launches,
    every counted entry point's launches in the phase's passes, and the phase's line."""
    from metrics_tpu_torch.checkpoint import CheckpointManager
    from metrics_tpu_torch.multistream import shard_spans
    from metrics_tpu_torch.ops import kll
    from metrics_tpu_torch.streaming.sketches import DEFAULT_CAPACITY, kll_rank_error_bound

    phase_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    data = _ms_data()
    logits, labels, sources, ce, ml_preds, ml_target, users = data
    feeds = _ms_feeds(*data)
    half = {k: len(v) // 2 for k, v in feeds.items()}
    metrics = _ms_metrics(mt)
    counters = _ms_counters(ops, kll)
    checks, passes = {}, {}

    def feed(metric, batches):
        for args, kwargs in batches:
            metric.update(*args, **kwargs)

    # the main path, halted halfway for the checkpoint; each metric's pass timed without the save
    for fn in counters.values():
        fn.launches = 0
    pass_s = {}
    for key, metric in metrics.items():
        torch.cuda.synchronize()
        start = time.perf_counter()
        feed(metric, feeds[key][: half[key]])
        torch.cuda.synchronize()
        pass_s[key] = time.perf_counter() - start
    halfway = {k: _states_of(m) for k, m in metrics.items()}
    ckpt_root = Path(tempfile.mkdtemp(prefix="ms_ckpt_"))
    managers = {k: CheckpointManager(str(ckpt_root / k)) for k in metrics}
    torch.cuda.synchronize()
    start = time.perf_counter()
    for k, m in metrics.items():
        managers[k].save(m)
    save_ms = (time.perf_counter() - start) * 1e3
    for key, metric in metrics.items():
        torch.cuda.synchronize()
        start = time.perf_counter()
        feed(metric, feeds[key][half[key] :])
        torch.cuda.synchronize()
        pass_s[key] += time.perf_counter() - start
    launches = {name: fn.launches for name, fn in counters.items()}
    implied = {"stream_logits": len(feeds["acc"]) + len(feeds["f1"]), "stream_canonical": len(feeds["top5"]),
               "logits": len(feeds["config2"]) * 2 + 1, "canonical": 0, "kll_fold": len(feeds["q"]) + len(feeds["h"])}
    print(f"multistream launches per entry point: {launches} (the passes imply {implied})")
    # config 2's groups: {acc}, {cm} and {f1, prec}: two logits launches a batch after the first's three
    if launches != implied:
        raise AssertionError("phase 12 did not launch the kernels as its passes imply")
    for key in metrics:
        n_batches = len(feeds[key])
        samples = sum(args[0].shape[0] for args, _ in feeds[key])
        passes[key] = {"seconds": pass_s[key], "updates_per_s": n_batches / pass_s[key], "samples_per_s": samples / pass_s[key]}
        print(f"multistream pass {key}: {n_batches} updates in {pass_s[key]!r} s, {n_batches / pass_s[key]!r} updates/s, "
              f"{samples / pass_s[key]!r} samples/s")

    # (a) integer states against numpy's counts, values within FLOAT_RTOL, rankings
    host_logits, host_labels = logits.cpu().numpy(), labels.cpu().numpy()
    pred = host_logits.argmax(1)
    top5 = np.argsort(-host_logits, axis=1, kind="stable")[:, :TOP_K]
    src = sources.cpu().numpy()
    want_acc = _stream_counts_np(pred, host_labels, host_labels, N_CLASSES, N_CLASSES, micro=True)
    want_f1 = _stream_counts_np(pred, host_labels, src, MS_SOURCES, N_CLASSES, micro=False)
    want_top5 = _stream_counts_np(top5, host_labels, host_labels, N_CLASSES, N_CLASSES, micro=True)
    compared = sum(_check_ms_counts(k, metrics[k], w) for k, w in (("acc", want_acc), ("f1", want_f1), ("top5", want_top5)))
    rows_a = np.bincount(host_labels, minlength=N_CLASSES)
    for key, want in (("acc", want_acc["tp"] / rows_a), ("top5", want_top5["tp"] / rows_a), ("f1", _f1_macro_np(want_f1))):
        got = metrics[key].compute().cpu().numpy()
        _check_rel(f"(a) {key} per stream", got, want, np.full(want.shape, FLOAT_RTOL), checks)
    acc_values = metrics["acc"].compute().cpu().numpy()
    _check_ranking("(a) acc", metrics["acc"], acc_values, 10, largest=False)
    _check_ranking("(a) acc", metrics["acc"], acc_values, 10, largest=True)
    compared += _ms_card_vs_plain(ops, mt, (logits[:BATCH], labels[:BATCH], sources[:BATCH]))

    # (b) per-user rows bitwise, values within their float32 bound, rankings, a query, a span
    u = users.cpu().numpy()
    p64, t64 = ml_preds.cpu().numpy().astype(np.float64), ml_target.cpu().numpy().astype(np.float64)
    rows_b = np.bincount(u, minlength=ML_USERS)
    if metrics["mse"].stream_rows.cpu().numpy().astype(np.int64).tobytes() != rows_b.astype(np.int64).tobytes():
        raise AssertionError("(b) stream_rows differ from numpy's bincount")
    rel = (rows_b + ML_UNITS_PAST_ROWS) * 2.0**-24
    with np.errstate(divide="ignore", invalid="ignore"):
        for key, terms in (("mse", (p64 - t64) ** 2), ("mae", np.abs(p64 - t64))):
            want = np.bincount(u, weights=terms, minlength=ML_USERS) / rows_b
            values = metrics[key].compute().cpu().numpy()
            _check_rel(f"(b) {key} per user", values, want, rel, checks)
            _check_ranking(f"(b) {key}", metrics[key], values, 10, largest=True)
            _check_ranking(f"(b) {key}", metrics[key], values, 10, largest=False)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 25)
    query = torch.randint(0, ML_USERS, (MS_COMPUTE_STREAMS,), generator=gen, device=DEVICE)
    if metrics["mse"].compute_streams(query).cpu().numpy().tobytes() != metrics["mse"].compute()[query].cpu().numpy().tobytes():
        raise AssertionError("(b) compute_streams differs from compute()'s rows")
    lo, hi = shard_spans(ML_USERS, 4)[1]
    recipient = mt.MultiStreamMetric(mt.MeanSquaredError(device=DEVICE), num_streams=hi - lo, device=DEVICE)
    recipient.adopt_stream_slice(0, metrics["mse"].stream_slice(lo, hi))
    donor = {k: v[lo:hi] for k, v in metrics["mse"].stream_slice(0, ML_USERS).items()}
    _same_states("(b) adopted span", donor, {k: getattr(recipient, k).cpu() for k in donor})
    if recipient.compute().cpu().numpy().tobytes() != metrics["mse"].compute()[lo:hi].cpu().numpy().tobytes():
        raise AssertionError("(b) the adopted span computes other values than its donor")
    print(f"check (b): stream_rows bitwise over {ML_USERS} users, top/bottom 10 as numpy ranks them, compute_streams of "
          f"{MS_COMPUTE_STREAMS} ids, span [{lo}, {hi}) adopted bitwise")

    # (c) rank errors per stream, dropped rows, one 1,000-sketch launch against the plain version
    q_metric = metrics["q"]
    host_ce = ce.cpu().numpy()
    kept = np.zeros(N_SAMPLES, bool)
    for i in range(0, N_SAMPLES, BATCH):
        n = min(BATCH, N_SAMPLES - i)
        m = min(n, max(8, -(-4 * n // N_CLASSES)))
        kept[i : i + n] = _staged_rows(host_labels[i : i + n], m)
    if q_metric.dropped_rows() != int((~kept).sum()):
        raise AssertionError(f"(c) dropped {q_metric.dropped_rows()} rows, numpy counts {int((~kept).sum())} past m")
    estimates = q_metric.compute().cpu().numpy()
    worst_share = 0.0
    order = np.argsort(host_labels[kept], kind="stable")
    grouped = np.split(host_ce[kept][order], np.cumsum(np.bincount(host_labels[kept], minlength=N_CLASSES))[:-1])
    for s in range(N_CLASSES):
        data_s = np.sort(grouped[s])
        errors = _rank_errors(estimates[s], MS_QUANTILES, data_s)
        worst_share = max(worst_share, float(errors.max()) / kll_rank_error_bound(data_s.size, DEFAULT_CAPACITY))
    checks["(c) rank errors"] = {"worst_share_of_bound": worst_share, "dropped_rows": q_metric.dropped_rows()}
    print(f"check (c): {N_CLASSES} streams' estimates within kll_rank_error_bound of their exact ranks (worst "
          f"{worst_share!r} of it), {q_metric.dropped_rows()} rows dropped past m as numpy counts")
    if worst_share > 1.0:
        raise AssertionError("(c) a stream's estimate lies outside kll_rank_error_bound")
    last_args, last_kwargs = feeds["q"][-1]
    before_last = mt.MultiStreamMetric(mt.StreamingQuantile(q=MS_QUANTILES, device=DEVICE), num_streams=N_CLASSES, device=DEVICE)
    feed(before_last, feeds["q"][:-1])
    card_twin = {k: v.clone() for k, v in before_last.state_pytree().items() if isinstance(v, torch.Tensor)}
    kll.kll_fold.launches = 0
    before_last.update(*last_args, **last_kwargs)
    if kll.kll_fold.launches != 1:
        raise AssertionError("(c) an update did not fold its 1,000 sketches in one kll_fold launch")
    plain_twin = mt.MultiStreamMetric(mt.StreamingQuantile(q=MS_QUANTILES, device=DEVICE), num_streams=N_CLASSES, device=DEVICE)
    plain_twin.load_state_pytree(card_twin)
    _with_plain_fold(lambda: plain_twin.update(*last_args, **last_kwargs))
    leaves = _same_leaves("(c) 1,000-sketch launch", before_last.sketch_tree("sketch"), plain_twin.sketch_tree("sketch"))
    print(f"check (c): one 1,000-sketch kll_fold launch bitwise against kll_fold_plain ({leaves} leaves, keys included)")
    compared += leaves

    # (c) the per-class histogram: each stream's counts against numpy's exact counts of its kept rows on the
    # metric's own edges, within twice the sketch's rank-error bound; the same pass on the CPU, bitwise
    h_metric = metrics["h"]
    if h_metric.dropped_rows() != q_metric.dropped_rows():
        raise AssertionError(f"(c) the histogram dropped {h_metric.dropped_rows()} rows, the quantiles {q_metric.dropped_rows()}")
    h_value = h_metric.compute()
    h_edges, h_counts = h_value["edges"].cpu().numpy(), h_value["counts"].cpu().numpy().astype(np.float64)
    worst_h, filled = 0.0, 0
    for s in range(N_CLASSES):
        data_s = np.sort(grouped[s])
        if data_s.size == 0:
            if h_counts[s].any():
                raise AssertionError(f"(c) stream {s} has no rows but histogram counts")
            continue
        filled += 1
        if h_edges[s][0] != data_s[0]:
            raise AssertionError(f"(c) stream {s}'s first edge is not its minimum")
        _, le = _exact_counts(data_s, h_edges[s])
        exact = np.diff(np.concatenate([[0], le[1:]])).astype(np.float64)  # bins (e_i, e_i+1], the first closed
        eps = 2 * kll_rank_error_bound(data_s.size, DEFAULT_CAPACITY)
        worst_h = max(worst_h, float(np.abs(h_counts[s] - exact).max()) / data_s.size / eps)
    checks["(c) histogram counts"] = {"worst_share_of_bound": worst_h, "streams": filled}
    print(f"check (c): {filled} streams' {MS_BINS}-bin histograms within twice kll_rank_error_bound of numpy's exact "
          f"counts (worst {worst_h!r} of it)")
    if worst_h > 1.0:
        raise AssertionError("(c) a stream's histogram counts lie outside the sketch's bound")
    # the pass's last update from the state before it, on the card and on the CPU (a CPU pass of 1,000 sketches
    # takes about a minute); then both computes
    h_args, h_kwargs = feeds["h"][-1]
    h_card = mt.MultiStreamMetric(mt.StreamingHistogram(bins=MS_BINS, device=DEVICE), num_streams=N_CLASSES, device=DEVICE)
    feed(h_card, feeds["h"][:-1])
    h_cpu = mt.MultiStreamMetric(mt.StreamingHistogram(bins=MS_BINS, device="cpu"), num_streams=N_CLASSES, device="cpu")
    h_cpu.load_state_pytree({k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in h_card.state_pytree().items()})
    h_card.update(*h_args, **h_kwargs)
    h_cpu.update(*(a.cpu() for a in h_args), stream_ids=h_kwargs["stream_ids"].cpu())
    compared += _same_states("(c) the histogram's last update on the card and the CPU", _states_of(h_card), _states_of(h_cpu))
    _same_states("(c) the histogram pass and its replay", _states_of(h_metric), _states_of(h_card))
    cpu_value = h_cpu.compute()
    for k in ("edges", "counts"):
        if h_value[k].cpu().numpy().tobytes() != cpu_value[k].numpy().tobytes():
            raise AssertionError(f"(c) the histogram's {k} on the card differ from the CPU's")
    print("check (c): the histogram's last update and compute on the card bitwise as on the CPU (states, edges, counts)")

    # (d) restore on the card, finish, and match the uninterrupted run; restore on the CPU, bitwise
    restored = _ms_metrics(mt)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for k, m in restored.items():
        CheckpointManager(str(ckpt_root / k)).restore(m)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - start) * 1e3
    for key, metric in restored.items():
        feed(metric, feeds[key][half[key] :])
        _same_states(f"(d) {key} restored halfway and finished", _states_of(metrics[key]), _states_of(metric))
    on_cpu = _ms_metrics(mt, device="cpu")
    for k, m in on_cpu.items():
        CheckpointManager(str(ckpt_root / k)).restore(m)
        _same_states(f"(d) {k} restored on the CPU", halfway[k], _states_of(m))
    written = sum(mgr.store.bytes_written for mgr in managers.values())
    fsyncs = sum(mgr.store.fsyncs for mgr in managers.values())
    print(f"check (d): {len(metrics)} checkpoints saved halfway in {save_ms!r} ms ({written} bytes, {fsyncs} fsyncs), "
          f"restored on the card in {restore_ms!r} ms and finished bitwise as the uninterrupted run; restored on the "
          f"CPU bitwise")
    del on_cpu, restored
    sync = phase_ms_sync(mt, metrics, Path(tempfile.mkdtemp(prefix="ms_sync_")) / "ranks")

    # per-update device operations and host copies, query times, peak memory
    updates = {}
    for key in ("acc", "f1", "top5", "mse", "q", "h"):
        fresh = _ms_metrics(mt)[key]
        args, kwargs = feeds[key][1]
        fresh.update(*args, **kwargs)
        ms = _call_ms(lambda: fresh.update(*args, **kwargs), reps=10, warmup=2)
        seen = max(((_device_ops(lambda: fresh.update(*args, **kwargs)) or []) for _ in range(PROFILER_ATTEMPTS)), key=len)
        updates[key] = {"update_ms": ms, "device_ops": len(seen), "device_to_host": sum("DtoH" in op for op, _ in seen)}
        print(f"multistream {key} update: {ms!r} ms, {len(seen)} device operations, {updates[key]['device_to_host']} "
              f"device->host copies (0: not counted where the profiler saw no device activity)")
    def uncached(metric):
        metric._computed = None  # compute() returns its cached value until the next update
        return metric.compute()

    queries = {
        "acc_compute_ms": _call_ms(lambda: uncached(metrics["acc"]), reps=10, warmup=2),
        "mse_compute_ms": _call_ms(lambda: uncached(metrics["mse"]), reps=10, warmup=2),
        "q_compute_ms": _call_ms(lambda: uncached(metrics["q"]), reps=10, warmup=2),
        "h_compute_ms": _call_ms(lambda: uncached(metrics["h"]), reps=10, warmup=2),
        "mse_top_k_ms": _call_ms(lambda: metrics["mse"].top_k(10), reps=10, warmup=2),
        "mse_compute_streams_ms": _call_ms(lambda: metrics["mse"].compute_streams(query), reps=10, warmup=2),
    }
    print(f"multistream queries: {queries}")
    secs = time.perf_counter() - phase_start
    peak = torch.cuda.max_memory_allocated()
    print(f"multistream phase took {secs:.1f} s, peak device memory {peak} bytes")
    line = {"multistream": {
        "card": card, "passes": passes, "updates": updates, "queries": queries, "checks": checks,
        "compared": compared, "checkpoint": {"save_ms": save_ms, "restore_ms": restore_ms, "bytes": written,
                                             "fsyncs": fsyncs, "two_ranks": sync},
        "launches": launches, "peak_bytes": peak, "phase_s": secs,
    }}
    stat_launches = {"logits": launches["logits"], "canonical": launches["canonical"]}
    return stat_launches, launches, line


# ------------------------------------------------------------ core and obs
ASYNC_STALL_SECS = 0.25  # the stalled peer's sleep before each collective of its async rounds
ASYNC_SUBMIT_LIMIT_MS = 100.0  # sync_async() must hand back its handles within this
CORE_WINDOW = 4  # (e)'s windows: buckets of WINDOW_BUCKET batches
CORE_SMALL_BATCHES = 10  # (f)'s small reruns of phases 11 and 12
LARGE_S_TIMED = (600, 1000, 5000)  # the large-S branch's timed calls, on the operands of tools/stream_stat_scores_ab.py
BF16_RTOL = 2.0**-8  # one bfloat16 ulp, relative


def _obs_profiles(mt, obs, logits: torch.Tensor, labels: torch.Tensor) -> dict:
    """(device operations, device->host copies) of one update with obs disabled and enabled, for phase 13's
    (a) and (f): a config-2 collection, a ``StreamingQuantile`` (capacity 2048) on a NYU-sized batch and a
    1,000-stream ``MultiStreamMetric(Accuracy)``.  The two states alternate over the sessions, and each count
    is the most any session recorded (a session may drop events, never add one).  Run before the curve
    phase: profiler sessions after it lose device events, and some lose them for a while."""
    x, t = logits[:BATCH], labels[:BATCH]
    col = _config2(mt)
    col.update(x, t)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 13)
    err = torch.rand(NYU_BATCH * NYU_H * NYU_W, generator=gen, device=DEVICE)
    q = mt.StreamingQuantile(q=SKETCH_Q, capacity=SKETCH_CAPACITY, device=DEVICE)
    q.update(err)
    ms = mt.MultiStreamMetric(mt.Accuracy(num_classes=N_CLASSES, device=DEVICE), num_streams=N_CLASSES, device=DEVICE)
    ms.update(x, t, stream_ids=t)
    probes = {"config2": lambda: col.update(x, t), "quantile": lambda: q.update(err),
              "multistream": lambda: ms.update(x, t, stream_ids=t)}
    seen = {name: {"disabled": [], "enabled": []} for name in probes}
    for _ in range(PROFILER_ATTEMPTS + 2):
        for label in ("disabled", "enabled"):
            if label == "enabled":
                obs.enable()
            else:
                obs.disable()
            for name, fn in probes.items():
                seen[name][label].append(_device_ops(fn) or [])
    obs.disable()
    obs.reset()
    out = {name: {label: (max(len(s) for s in sessions), max(sum("DtoH" in op for op, _ in s) for s in sessions))
                  if any(sessions) else None for label, sessions in by_state.items()}
           for name, by_state in seen.items()}
    print(f"obs profiles, (device operations, device->host copies) of one update with obs disabled / enabled: {out}")
    return out


def _profiled(seen: dict, where: str) -> bool:
    """Whether both obs states of ``seen`` were profiled.  The host-copy gates need both: on the card a
    state that no session recorded fails the run; off the card the profiler records no device operations."""
    if DEVICE == "cuda" and None in seen.values():
        raise AssertionError(f"{where}: the profiler recorded no device operations of an update in "
                             f"{PROFILER_ATTEMPTS + 2} sessions: {seen}")
    return None not in seen.values()


def _launches_of(counters: dict, run) -> Tuple[object, dict]:
    """Run ``run`` with every launch count set to 0 just before it; the counts just after."""
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    out = run()
    torch.cuda.synchronize()
    return out, {name: fn.launches for name, fn in counters.items()}


def _spread(values: list) -> dict:
    ordered = sorted(values)
    return {"median": statistics.median(ordered), "min": ordered[0], "max": ordered[-1],
            "p90": ordered[min(len(ordered) - 1, int(0.9 * len(ordered)))]}


def _core_obs_main_path(mt, ops, obs, batches, single: dict, profile: dict) -> Tuple[dict, int]:
    """(a) config 2 through the stat-scores kernel with obs off, then on: the same integers as phase 4,
    the launches its groups imply, the same device operations and host copies per update."""
    n_batches = len(batches)
    out, launches = {}, 0
    # in turns, disabled, enabled, enabled, disabled: the host's drift falls on both alike
    for turn, (label, enabled) in enumerate((("disabled", False), ("enabled", True), ("enabled", True), ("disabled", False))):
        obs.reset()
        if enabled:
            obs.enable()
        else:
            obs.disable()
        col = _config2(mt)
        update_ms = []

        def run():
            for preds, target in batches:
                torch.cuda.synchronize()
                start = time.perf_counter()
                col.update(preds, target)
                torch.cuda.synchronize()
                update_ms.append((time.perf_counter() - start) * 1e3)
            return col.compute()

        _, secs, counts = _driven(ops, f"core_obs (a) config 2, obs {label} (turn {turn})", run,
                                  lambda: _implied_config2(ops, col, n_batches))
        launches += counts["logits"]
        got = _integer_results(col)
        for key, want in single.items():
            if got[key].dtype != torch.int32 or not torch.equal(got[key], want):
                raise AssertionError(f"core_obs (a), obs {label}: {key} differs from phase 4's")
        spans = obs.spans_snapshot()
        span_counts = {name: sum(int(agg[0]) for (n, _), agg in spans.items() if n == name)
                       for name in ("collection.update", "metric.update", "collection.compute", "metric.compute", "metric.sync")}
        # every member updates on the first batch, one member a compute group after it
        member_updates = len(col) + len(col.compute_groups) * (n_batches - 1)
        if enabled and (span_counts["collection.update"] != n_batches or span_counts["metric.update"] != member_updates
                        or span_counts["collection.compute"] != 1):
            raise AssertionError(f"core_obs (a): spans {span_counts} do not match {n_batches} collection updates and "
                                 f"{member_updates} member updates")
        if not enabled and spans:
            raise AssertionError(f"core_obs (a): spans recorded while obs was disabled: {sorted(spans)}")
        text = obs.prometheus_text()
        series = [line for line in text.splitlines() if line and not line.startswith("#")]
        parsed = obs.parse_prometheus_text(text)
        if len(parsed) != len(series):
            raise AssertionError(f"core_obs (a): {len(series)} series lines parse back to {len(parsed)}")
        seen = {
            "update_ms": _spread(update_ms), "samples_per_s": N_SAMPLES / secs, "spans": span_counts, "summarize_counters": obs.summarize_counters(),
            "prometheus_lines": len(text.splitlines()), "prometheus_series": len(parsed),
        }
        out.setdefault(label, []).append(seen)
        print(f"core_obs (a) obs {label}, turn {turn}: ms per update {seen['update_ms']!r}, {seen['samples_per_s']!r} "
              f"samples/s, spans {span_counts}, "
              f"summarize_counters {seen['summarize_counters']}, prometheus_text {seen['prometheus_lines']} "
              f"lines ({len(parsed)} series parsed back)")
    obs.disable()
    obs.reset()
    out["per_update"] = profile
    if _profiled(profile, "core_obs (a) config 2") and profile["disabled"] != profile["enabled"]:
        raise AssertionError(f"core_obs (a): obs changed an update's (device operations, host copies): {profile}")
    medians = {label: [t["update_ms"]["median"] for t in out[label]] for label in ("disabled", "enabled")}
    # one span's own host cost: enter and exit of an enabled span, and the flag check of a disabled one
    spans_timed = 20_000
    for label, enabled in (("span_us_enabled", True), ("span_us_disabled", False)):
        if enabled:
            obs.enable()
        start = time.perf_counter()
        for _ in range(spans_timed):
            if obs.enabled():
                with obs.span("metric.update", metric="Accuracy"):
                    pass
        out[label] = (time.perf_counter() - start) / spans_timed * 1e6
        obs.disable()
    obs.reset()
    print(f"check core_obs (a): integers bitwise as phase 4, launches as the groups imply, spans and counters as "
          f"recorded, (device operations, host copies) per update {profile} with obs off and on; median ms per update "
          f"by turn {medians}; one span {out['span_us_enabled']!r} us enabled, {out['span_us_disabled']!r} us disabled")
    return out, launches


def _async_collection(mt, backend=None):
    """Configuration 2 and a buffer-state member (AUROC) in one collection, every member syncing
    through ``backend`` (the default process group's when None)."""
    kw = {"device": DEVICE} if backend is None else {"device": DEVICE, "sync_backend": backend}
    return mt.MetricCollection(
        {
            "acc": mt.Accuracy(num_classes=N_CLASSES, average="macro", **kw),
            "f1": mt.F1Score(num_classes=N_CLASSES, average="macro", **kw),
            "prec": mt.Precision(num_classes=N_CLASSES, average="macro", **kw),
            "cm": mt.ConfusionMatrix(num_classes=N_CLASSES, **kw),
            "auroc": mt.AUROC(num_classes=N_CLASSES, **kw),
        },
        device=DEVICE,
    )


def _timed_submits(col) -> dict:
    """Record, per member, the ms its ``sync_async`` takes when the collection submits its group leaders."""
    times = {}
    for name, metric in col.items():
        def timed(*args, _submit=metric.sync_async, _name=name, **kwargs):
            start = time.perf_counter()
            handle = _submit(*args, **kwargs)
            times[_name] = (time.perf_counter() - start) * 1e3
            return handle
        metric.sync_async = timed
    return times


def _submit_diagnosis(mt, backend, batches) -> dict:
    """Where a submit's time goes, after the timed (first) one: ``sync_async()`` on fresh collections of this
    rank's rows with the worker held (parked on an event until every submit has returned, so no round runs
    meanwhile), with it free (as in the timed run), and free with the interpreter's switch interval cut from
    its 5 ms to 0.1 ms.  Every round ends before the next condition starts."""
    from metrics_tpu_torch.parallel import submit_async_round

    out = {}
    for label in ("held", "free", "free_switch_0.1ms"):
        col = _async_collection(mt, backend)
        for probs, target in _probability_batches(batches):
            col.update(probs, target)
        torch.cuda.synchronize()
        times = _timed_submits(col)
        gate, interval = threading.Event(), sys.getswitchinterval()
        if label == "held":
            submit_async_round(gate.wait, label="held")
        if label == "free_switch_0.1ms":
            sys.setswitchinterval(1e-4)
        try:
            start = time.perf_counter()
            handles = col.sync_async()
            submit_ms = (time.perf_counter() - start) * 1e3
        finally:
            sys.setswitchinterval(interval)
            gate.set()
        for handle in handles.values():
            handle.result()
        out[label] = {"submit_ms": submit_ms, "by_member": times}
    return out


def _rank_async(mt, ops, rank: int, batches, out: Path) -> None:
    """This rank's share of the probabilities through config 2 and AUROC, one async round per group
    leader (rank 1 a stalled peer: a sleep before each of its collectives), then compute(): rank 0
    reaches the catch-up barrier while the stalled rounds run, rank 1 after them."""
    from metrics_tpu_torch import obs
    from metrics_tpu_torch.parallel import ChaosBackend, DistBackend

    inner = DistBackend()
    backend = ChaosBackend(inner, packed=True, stall_secs=ASYNC_STALL_SECS) if rank == 1 else inner
    col = _async_collection(mt, backend)
    first, stop = SYNC_SHARDS[rank]
    for fn in _counters(ops).values():
        fn.launches = 0
    for probs, target in _probability_batches(batches[first:stop]):
        col.update(probs, target)
    torch.cuda.synchronize()
    launches = {route: fn.launches for route, fn in _counters(ops).items()}
    backend.for_async()  # makes the worker's process group (a collective itself) before the timing
    obs.reset()
    submit_by_member = _timed_submits(col)
    start = time.perf_counter()
    handles = col.sync_async()
    submit_ms = (time.perf_counter() - start) * 1e3
    if any(h is None for h in handles.values()):
        raise AssertionError(f"rank {rank}: a member started no async round: {handles}")
    if rank == 1:
        for handle in handles.values():
            handle.wait()
        backend.stall_secs = 0.0  # the peer recovers: the synchronous syncs below run unstalled
    start = time.perf_counter()
    results = col.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - start) * 1e3
    folds = [r for m in col.values() for r in m.sync_report_history if r.get("async")]
    torch.save({k: v.cpu() for k, v in results.items()}, out / f"rank{rank}.pt")
    sync = obs.summarize_counters().get("sync", {})
    diagnosis = _submit_diagnosis(mt, backend, batches[first:stop])
    (out / f"rank{rank}.json").write_text(json.dumps({
        "submit_ms": submit_ms, "submit_by_member": submit_by_member, "diagnosis": diagnosis,
        "compute_ms": compute_ms, "handles": sorted(handles),
        "errors": [h.error is not None for h in handles.values()],
        "overlap_secs": [r["overlap_secs"] for r in folds], "fold_errors": [r["error"] for r in folds],
        "sync": sync, "launches": launches,
        "devices": sorted({str(v.device) for v in results.values()}),
    }))


def _core_async(mt, batches) -> dict:
    """(b) the two-rank async scenario against one process's synchronous pass, bitwise."""
    col = _async_collection(mt)
    for probs, target in _probability_batches(batches):
        col.update(probs, target)
    single = {k: v.cpu() for k, v in col.compute().items()}
    del col
    with tempfile.TemporaryDirectory(prefix="chip_smoke_async_") as tmp:
        where = Path(tmp) / "async"
        start = time.perf_counter()
        seen = _wait_ranks("async", _start_ranks("async", where), where)
        ranks_s = time.perf_counter() - start
        got = [torch.load(where / f"rank{rank}.pt") for rank in range(SYNC_WORLD)]
    for rank, (info, res) in enumerate(zip(seen, got)):
        if info["submit_ms"] >= ASYNC_SUBMIT_LIMIT_MS:
            raise AssertionError(f"core_obs (b) rank {rank}: sync_async() took {info['submit_ms']} ms")
        if any(info["errors"]) or any(info["fold_errors"]) or info["devices"] != [str(torch.device(DEVICE, 0) if DEVICE == "cuda" else DEVICE)]:
            raise AssertionError(f"core_obs (b) rank {rank}: {info}")
        if info["sync"].get("async_rounds") != len(info["handles"]) or len(info["overlap_secs"]) != len(info["handles"]):
            raise AssertionError(f"core_obs (b) rank {rank}: {info['sync']} for {len(info['handles'])} rounds")
        for key, want in single.items():
            if res[key].dtype != want.dtype or not torch.equal(res[key], want):
                raise AssertionError(f"core_obs (b) rank {rank}: {key} differs from the synchronous single-process pass")
    if not seen[0]["sync"].get("catchup_barriers"):
        raise AssertionError(f"core_obs (b): rank 0 reached compute() before the stalled rounds ended, yet counted "
                             f"no catch-up barrier: {seen[0]['sync']}")
    print(f"check core_obs (b): sync_async() returned in {[s['submit_ms'] for s in seen]!r} ms on ranks 0/1 "
          f"(limit {ASYNC_SUBMIT_LIMIT_MS}), rounds {seen[0]['handles']}, overlap_secs {[s['overlap_secs'] for s in seen]!r}, "
          f"counters {[s['sync'] for s in seen]}; both ranks' compute() bitwise equal to the synchronous pass "
          f"({sorted(single)}); two ranks took {ranks_s:.1f} s")
    for rank, info in enumerate(seen):
        print(f"core_obs (b) rank {rank} submit ms by member, first submit {info['submit_by_member']!r}; after it, "
              + "; ".join(f"{label} {d['submit_ms']!r} by member {d['by_member']!r}" for label, d in info["diagnosis"].items()))
    return {"submit_ms": [s["submit_ms"] for s in seen], "compute_ms": [s["compute_ms"] for s in seen],
            "submit_by_member": [s["submit_by_member"] for s in seen], "submit_diagnosis": [s["diagnosis"] for s in seen],
            "overlap_secs": [s["overlap_secs"] for s in seen], "sync_counters": [s["sync"] for s in seen],
            "stall_secs": ASYNC_STALL_SECS, "rounds": seen[0]["handles"],
            "logits_launches_per_rank": [s["launches"]["logits"] for s in seen], "ranks_s": ranks_s}


def _compositions(mt, device):
    return {
        "(f1 + acc) / 2": (mt.F1Score(num_classes=N_CLASSES, average="macro", device=device)
                           + mt.Accuracy(num_classes=N_CLASSES, device=device)) / 2,
        "-prec": -mt.Precision(num_classes=N_CLASSES, average="macro", device=device),
        "acc(None)[7]": mt.Accuracy(num_classes=N_CLASSES, average=None, device=device)[7],
    }


def _core_composition(mt, ops, batches) -> Tuple[dict, int]:
    """(c) compositions fed by forward per batch: bitwise against the same arithmetic on their
    operands' own compute() on the card, and against the CPU path."""
    comps = _compositions(mt, DEVICE)
    mean = comps["(f1 + acc) / 2"]
    leaves = [mean.metric_a.metric_a, mean.metric_a.metric_b, comps["-prec"].metric_a, comps["acc(None)[7]"].metric_a]

    def implied() -> dict:
        expected = {route: 0 for route in _counters(ops)}
        for leaf in leaves:
            expected[_route(leaf)] += len(batches)
        return expected

    def run():
        steps = [[comp(x, t) for comp in comps.values()] for x, t in batches]
        return steps, [comp.compute() for comp in comps.values()]

    (card_steps, card_final), secs, counts = _driven(ops, "core_obs (c) compositions", run, implied)
    f1, acc, two = mean.metric_a.metric_a, mean.metric_a.metric_b, mean.metric_b
    by_hand = [torch.divide(torch.add(f1.compute(), acc.compute()), two),
               -torch.abs(comps["-prec"].metric_a.compute()), comps["acc(None)[7]"].metric_a.compute()[7]]
    for name, got, want in zip(comps, card_final, by_hand):
        if got.dtype != want.dtype or not _same_values(got, want):
            raise AssertionError(f"core_obs (c) {name}: {got!r} is not the operands' compute() combined by hand {want!r}")
    start = time.perf_counter()
    cpu = _compositions(mt, "cpu")
    cpu_steps = [[comp(x.cpu(), t.cpu()) for comp in cpu.values()] for x, t in batches]
    cpu_final = [comp.compute() for comp in cpu.values()]
    cpu_s = time.perf_counter() - start
    # acc(None)[7] is a ratio of integer counts: bitwise; the macro means sum 1,000 class scores in an order
    # the device picks: within C x 2^-24 relative
    # (a batch without class 7 gives NaN on both sides, the card's NaN with other bits: compared by position)
    worst = {}
    for i, name in enumerate(comps):
        pairs = [(s[i].cpu(), c[i]) for s, c in zip(card_steps, cpu_steps)] + [(card_final[i].cpu(), cpu_final[i])]
        finite = [(a, b) for a, b in pairs if not (torch.isnan(a) or torch.isnan(b))]
        diff = max((abs(float(a) - float(b)) / max(abs(float(b)), 1e-30) for a, b in finite), default=0.0)
        worst[name] = diff
        exact = name == "acc(None)[7]"
        if any(a.dtype != b.dtype or bool(torch.isnan(a)) != bool(torch.isnan(b)) for a, b in pairs) \
                or (exact and any(not _same_values(a, b) for a, b in pairs)) or diff > N_CLASSES * 2.0**-24:
            raise AssertionError(f"core_obs (c) {name}: the card differs from the CPU path by {diff!r} relative")
    print(f"check core_obs (c): {list(comps)} over {len(batches)} forward steps, bitwise as their operands' compute() "
          f"combined by hand on the card; against the CPU path ({cpu_s:.1f} s): worst relative difference {worst} "
          f"(acc(None)[7] bitwise; macro means within {N_CLASSES} x 2^-24)")
    values = {name: float(v) for name, v in zip(comps, card_final)}
    return {"values": values, "vs_cpu_worst_rel": worst, "launches": counts, "samples_per_s": N_SAMPLES / secs}, counts["logits"]


def _core_dtype_placement(mt, prob_batches) -> dict:
    """(d) MeanSquaredError().half() over the NYU-shaped pass, on the card and the CPU; AUROC with
    compute_on_cpu over the ImageNet probabilities beside a device-resident AUROC."""
    nyu = _nyu_pass()
    out = {}
    results = {}
    for where in (DEVICE, "cpu"):
        m = mt.MeanSquaredError(device=where).half()
        dtypes = {"after_half": str(m.sum_squared_error.dtype)}
        for p, t in nyu:
            m.update(p.to(torch.bfloat16).to(where), t.to(torch.bfloat16).to(where))
        dtypes["after_updates"] = str(m.sum_squared_error.dtype)  # float32: the update accumulates in float32
        sse32 = m.sum_squared_error.cpu()
        m.half()
        dtypes["states"] = str(m.sum_squared_error.dtype)
        results[str(where)] = (sse32, m.total.cpu(), m.compute().cpu(), m.sum_squared_error.cpu(), dtypes)
    card, cpu = results[DEVICE], results["cpu"]
    sse_rel = abs(float(card[0]) - float(cpu[0])) / float(cpu[0])
    if card[4] != cpu[4] or card[4]["states"] != "torch.bfloat16" or not torch.equal(card[1], cpu[1]):
        raise AssertionError(f"core_obs (d) MSE: dtypes {card[4]} / {cpu[4]}, totals {card[1]} / {cpu[1]}")
    if sse_rel > SUM_DEPTH * 2.0**-24:
        raise AssertionError(f"core_obs (d) MSE: the float32 sums differ by {sse_rel!r} relative")
    for a, b in ((card[2], cpu[2]), (card[3], cpu[3])):
        if a.dtype != torch.bfloat16 or abs(float(a) - float(b)) > BF16_RTOL * abs(float(b)):
            raise AssertionError(f"core_obs (d) MSE: bf16 {a!r} against the CPU's {b!r}")
    out["mse_half"] = {"dtypes": card[4], "value": float(card[2]), "cpu_value": float(cpu[2]),
                       "bf16_ulps_apart": abs(int(card[2].view(torch.int16)) - int(cpu[2].view(torch.int16))),
                       "float32_sum_rel_diff": sse_rel}
    print(f"check core_obs (d) MSE().half(): dtypes {card[4]} (the update accumulates in float32, as in the JAX "
          f"package), bf16 value {float(card[2])!r} on the card, {float(cpu[2])!r} on the CPU "
          f"({out['mse_half']['bf16_ulps_apart']} bf16 ulps apart), float32 sums {sse_rel!r} apart")
    del nyu

    runs = {}
    for label, kwargs in (("device_resident", {}), ("compute_on_cpu", {"compute_on_cpu": True})):
        metric = mt.AUROC(num_classes=N_CLASSES, device=DEVICE, **kwargs)
        update_ms = []

        def run():
            for probs, target in prob_batches:
                torch.cuda.synchronize()
                start = time.perf_counter()
                metric.update(probs, target)
                torch.cuda.synchronize()
                update_ms.append((time.perf_counter() - start) * 1e3)
            start = time.perf_counter()
            value = metric.compute()
            torch.cuda.synchronize()
            return value, (time.perf_counter() - start) * 1e3

        (value, compute_ms), peak = _peak_bytes(run)
        runs[label] = {"value": value, "peak_bytes": peak, "update_ms": _spread(update_ms), "compute_ms": compute_ms,
                       "buffer_device": str(metric.preds__buf.device)}
        del metric
    dev, host = runs["device_resident"], runs["compute_on_cpu"]
    bitwise = torch.equal(dev["value"].cpu(), host["value"].cpu())
    rel = abs(float(dev["value"]) - float(host["value"])) / abs(float(dev["value"]))
    if host["buffer_device"] != "cpu" or host["value"].device.type != "cpu" or not (bitwise or rel <= CURVE_RTOL):
        raise AssertionError(f"core_obs (d) AUROC(compute_on_cpu=True): {host} against {dev}")
    out["auroc_compute_on_cpu"] = {
        label: {k: (float(v) if k == "value" else v) for k, v in r.items()} for label, r in runs.items()
    }
    out["auroc_compute_on_cpu"]["bitwise"] = bitwise
    out["auroc_compute_on_cpu"]["rel_diff"] = rel
    print(f"check core_obs (d) AUROC: compute_on_cpu keeps the rows in host memory ({host['buffer_device']}), "
          f"peak device bytes {host['peak_bytes']} against {dev['peak_bytes']} device-resident, ms per update "
          f"{host['update_ms']['median']!r} against {dev['update_ms']['median']!r}, compute {host['compute_ms']!r} ms "
          f"(on the CPU) against {dev['compute_ms']!r}; values {'bitwise equal' if bitwise else f'{rel!r} apart (rtol {CURVE_RTOL})'}")
    return out


def _core_windows(mt, ops, batches) -> Tuple[dict, int]:
    """(e) two windows of one base in a collection (one compute group) against two windows advanced one by one."""
    def windows():
        return {f"w{i}": mt.WindowedMetric(mt.Accuracy(num_classes=N_CLASSES, device=DEVICE), window_size=CORE_WINDOW,
                                           device=DEVICE) for i in (1, 2)}

    def drive(update, advance, compute):
        trace, step = [], 0
        for _ in range(2):
            for x, t in batches:
                update(x, t)
                step += 1
                if step % WINDOW_BUCKET == 0:
                    trace.append((advance(), compute()))
        return trace

    col = mt.MetricCollection(windows(), device=DEVICE)
    total = 2 * len(batches)
    grouped, _, counts = _driven(
        ops, "core_obs (e) windows in one compute group",
        lambda: drive(col.update, col.advance_windows, col.compute),
        lambda: {"logits": total + 1, "canonical": 0},  # both members on the first batch, then the leader alone
    )
    alone = windows()
    members = list(alone.values())
    one_by_one = drive(lambda x, t: [m.update(x, t) for m in members], lambda: {k: m.advance() for k, m in alone.items()},
                       lambda: {k: m.compute() for k, m in alone.items()})
    for (ev, vals), (ev1, vals1) in zip(grouped, one_by_one):
        if ev != {"w1": ev1["w1"]} or ev1["w1"] != ev1["w2"] or any(not torch.equal(vals[k], vals1[k]) for k in vals1):
            raise AssertionError(f"core_obs (e): advance_windows gave {ev} and {vals}, the members one by one {ev1} and {vals1}")
    if col.compute_groups != {0: ["w1", "w2"]}:
        raise AssertionError(f"core_obs (e): compute groups {col.compute_groups}")
    evicted = [ev["w1"] for ev, _ in grouped]
    print(f"check core_obs (e): {len(grouped)} advances over two passes, evicted {evicted}, every window's value bitwise "
          f"as the members advanced one by one; {counts['logits']} launches for {total} batches")
    return {"advances": len(grouped), "evicted": evicted, "launches": counts}, counts["logits"]


def _core_done_slices(mt, ops, obs, batches, profiles: dict) -> Tuple[dict, dict]:
    """(f) small reruns of phases 11 and 12 with obs enabled: their counters reach summarize_counters(),
    and an update's device operations and host copies are those with obs disabled."""
    from metrics_tpu_torch.checkpoint import CheckpointManager
    from metrics_tpu_torch.ops import kll
    from metrics_tpu_torch.parallel import LoopbackBackend

    counters = _ms_counters(ops, kll)
    err = [(p - t).abs_().div_(t) for p, t in _nyu_pass()[:CORE_SMALL_BATCHES]]
    small = batches[:CORE_SMALL_BATCHES]
    q = mt.StreamingQuantile(q=SKETCH_Q, capacity=SKETCH_CAPACITY, device=DEVICE, sync_backend=LoopbackBackend())
    win = mt.WindowedMetric(mt.SumMetric(device=DEVICE), window_size=2, device=DEVICE)
    ms = mt.MultiStreamMetric(mt.Accuracy(num_classes=N_CLASSES, device=DEVICE), num_streams=N_CLASSES, device=DEVICE,
                              sync_backend=LoopbackBackend())
    obs.reset()
    obs.enable()

    def run():
        for e in err:
            q.update(e)
            win.update(e.sum())
            win.advance()
        for x, t in small:
            ms.update(x, t, stream_ids=t)
        q.compute()
        ms.top_k(10)
        ms.where(lambda v: v > 0.5, 10)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
            CheckpointManager(tmp).save(ms)
            CheckpointManager(tmp).restore(mt.MultiStreamMetric(mt.Accuracy(num_classes=N_CLASSES, device=DEVICE),
                                                                num_streams=N_CLASSES, device=DEVICE))

    _, launches = _launches_of(counters, run)
    summary = obs.summarize_counters()
    obs.disable()
    obs.reset()
    need = {"streaming": {"sketch_compactions", "window_evictions", "sketch_merge_calls"},
            "multistream": {"scatter_updates", "topk_queries", "streams_active", "sync_bytes"},
            "ckpt": {"saves", "restores", "bytes_written"}}
    missing = {k: sorted(v - set(summary.get(k, {}))) for k, v in need.items() if v - set(summary.get(k, {}))}
    if missing:
        raise AssertionError(f"core_obs (f): counters missing from summarize_counters(): {missing} ({summary})")
    if launches["kll_fold"] < len(err) or launches["stream_logits"] != len(small):
        raise AssertionError(f"core_obs (f): launches {launches}")
    # the host copies are the gate: a sketch update's operation count moves with its state (which levels compact)
    per_update = {name: profiles[name] for name in ("quantile", "multistream")}
    for name, seen in per_update.items():
        if _profiled(seen, f"core_obs (f) {name}") and seen["disabled"][1] != seen["enabled"][1]:
            raise AssertionError(f"core_obs (f) {name}: obs changed an update's host copies: {seen}")
    print(f"check core_obs (f): summarize_counters() holds {summary}; per update (device operations, device->host "
          f"copies) with obs off and on {per_update}; launches {launches}")
    return {"summarize_counters": summary, "per_update": per_update, "launches": launches}, launches


def _large_s_timings(ops) -> list:
    """The large-S branch of the canonical per-stream entry point against its plain version, in turns, on the
    operands ``tools/stream_stat_scores_ab.py`` times it on (the same generator draws)."""
    n, c = BATCH, N_CLASSES
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 24)
    torch.randn((n, c), generator=gen, device=DEVICE)
    torch.randint(0, c, (n,), generator=gen, device=DEVICE)
    torch.randint(0, 64, (n,), generator=gen, device=DEVICE)
    preds = torch.randint(0, 2, (n, c), generator=gen, device=DEVICE, dtype=torch.int32)
    target = torch.randint(0, 2, (n, c), generator=gen, device=DEVICE, dtype=torch.int32)
    out = []
    for s in LARGE_S_TIMED:
        ids = torch.randint(0, s, (n,), generator=gen, device=DEVICE)
        kernel = lambda: ops.fused_stream_stat_scores(preds, target, ids, s)  # noqa: E731
        plain = lambda: ops.fused_stream_stat_scores_plain(preds, target, ids, s)  # noqa: E731
        for a, b in zip(kernel(), plain()):
            if not torch.equal(a, b):
                raise AssertionError(f"large S = {s}: the kernel differs from its plain version")
        times = _in_turns({"plain": plain, "kernel": kernel}, ["plain", "kernel", "kernel", "plain"])
        bound_ms, bound_by = _bound(2 * n * c * 4 + n * 8 + 4 * s * c * 4, 6 * n * c)
        out.append({"streams": s, "ms": times["kernel"], "plain_ms": times["plain"], "bound_ms": bound_ms, "bound_by": bound_by})
        print(f"stream_stat_scores large S = {s}: kernel {times['kernel']!r} ms, plain {times['plain']!r} ms, "
              f"bound {bound_ms!r} ms ({bound_by})")
    return out


def phase_core_obs(mt, ops, single: dict, profiles: dict, card: str) -> Tuple[dict, dict, dict]:
    """Phase 13: the rest of the Metric core and obs, with the update profiles ``_obs_profiles`` took early.
    Returns the stat-scores launches by route, the launches of the per-stream and kll_fold kernels, and
    the core_obs line."""
    from metrics_tpu_torch import obs

    phase_start = time.perf_counter()
    logits, labels, batches = _imagenet_pass()
    obs_main, obs_launches = _core_obs_main_path(mt, ops, obs, batches, single, profiles["config2"])
    asynchronous = _core_async(mt, batches)
    composition, comp_launches = _core_composition(mt, ops, batches)
    prob_batches = _probability_batches(batches)
    dtype_placement = _core_dtype_placement(mt, prob_batches)
    del prob_batches
    windows, window_launches = _core_windows(mt, ops, batches)
    done_slices, done_launches = _core_done_slices(mt, ops, obs, batches, profiles)
    del logits, labels, batches
    large_s = _large_s_timings(ops)
    secs = time.perf_counter() - phase_start
    print(f"core_obs phase took {secs:.1f} s")
    stat = {"logits": obs_launches + comp_launches + window_launches + done_launches["logits"],
            "canonical": done_launches["canonical"]}
    line = {"core_obs": {
        "card": card, "obs_on_main_path": obs_main, "async_two_ranks": asynchronous, "composition": composition,
        "dtype_and_placement": dtype_placement, "windows": windows, "done_slices": done_slices,
        "launches": {**stat, "stream_logits": done_launches["stream_logits"],
                     "stream_canonical": done_launches["stream_canonical"], "kll_fold": done_launches["kll_fold"]},
        "large_s": large_s, "phase_s": secs,
    }}
    others = {k: done_launches[k] for k in ("stream_logits", "stream_canonical", "kll_fold")}
    return stat, others, line


# ---------------------------------------------------------------------------------------------------------------
# Phase 14: detection (COCO mAP, the coco_match kernel) and the first image metrics
# ---------------------------------------------------------------------------------------------------------------
COCO_IMAGES, COCO_H, COCO_W, COCO_CLASSES = 5000, 480, 640, 80  # COCO val2017: images, a common canvas, classes
COCO_GTS = 36_781  # val2017's instance annotations
COCO_DETS, COCO_BATCH = 100, 16  # detections per image (the maxDets cap), images per update
# instance areas below 32^2, between 32^2 and 96^2, above: about 41 %, 34 % and 25 % of COCO's instances
COCO_AREA_SHARES = (0.41, 0.34, 0.25)
COCO_SEGM_IMAGES = 500  # (b): the masks' COCO RLE strings are encoded on the host in setup
COCO_SYNC_STEPS, COCO_SYNC_STEP_IMAGES = 25, 10  # (c): 25 steps of 10 images a rank: 500 images
MAP_VALUE_TOL = 1e-6  # float32 precision-table values against the float64 host route, averaged into mAP
DIV2K_IMAGES, DIV2K_H, DIV2K_W, DIV2K_BATCH = 100, 1356, 2040, 4  # DIV2K validation HR: 100 RGB images
PAN_PATCHES, PAN_BANDS, PAN_SIZE, PAN_BATCH = 1000, 4, 256, 32  # 4-band pan-sharpening patches
# card against CPU, per image: float32 window sums and means over millions of pixels in another order
IMAGE_ATOL, IMAGE_RTOL = 1e-5, 1e-5
MATCH_TIE_CASES = 3  # planted-tie operands of (d), each a new seed


def _coco_counts(rng: np.random.Generator, n_images: int, total: int) -> np.ndarray:
    """Gts per image: geometric (a heavy tail, at most 100), nudged to ``total`` exactly."""
    counts = np.minimum(rng.geometric(n_images / total, n_images), 100)
    while (diff := total - int(counts.sum())) != 0:
        idx = np.unique(rng.integers(0, n_images, abs(diff)))
        counts[idx] = np.clip(counts[idx] + np.sign(diff), 0, 100)
    return counts


def _coco_boxes(rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` integer xyxy boxes on the canvas, their areas drawn log-uniform in COCO's three ranges."""
    kind = rng.choice(3, n, p=COCO_AREA_SHARES)
    lo = np.array([16.0, 32.0**2, 96.0**2])[kind]
    hi = np.array([32.0**2, 96.0**2, 400.0**2])[kind]
    area = np.exp(rng.uniform(np.log(lo), np.log(hi)))
    aspect = np.exp(rng.uniform(-0.7, 0.7, n))
    w = np.clip(np.round(np.sqrt(area * aspect)), 2, COCO_W - 1)
    h = np.clip(np.round(np.sqrt(area / aspect)), 2, COCO_H - 1)
    x0 = np.floor(rng.random(n) * (COCO_W - w + 1))
    y0 = np.floor(rng.random(n) * (COCO_H - h + 1))
    return np.stack([x0, y0, x0 + w, y0 + h], 1)


def _coco_scene(seed: int, n_images: int, n_gts: int) -> dict:
    """A COCO-val-shaped scene: per image its gts (heavy-tailed counts, 80 classes with a dominant head)
    and 100 detections, the first up to three per gt jittered copies of it with its class, the rest
    random boxes of its classes or of others.  Integer pixel coordinates (exact float32 box terms);
    flat arrays with per-image counts."""
    rng = np.random.default_rng(seed)
    g_counts = _coco_counts(rng, n_images, n_gts)
    class_p = 1.0 / np.arange(1, COCO_CLASSES + 1) ** 0.9
    class_p /= class_p.sum()
    gt_boxes = _coco_boxes(rng, n_gts)
    gt_labels = rng.choice(COCO_CLASSES, n_gts, p=class_p)
    g_start = np.cumsum(np.r_[0, g_counts[:-1]])
    img = np.repeat(np.arange(n_images), COCO_DETS)
    j = np.tile(np.arange(COCO_DETS), n_images)
    n_g = g_counts[img]
    matched = j < np.minimum(3 * n_g, COCO_DETS)
    src = g_start[img] + np.where(n_g > 0, j % np.maximum(n_g, 1), 0)
    src = np.minimum(src, n_gts - 1)
    size = np.stack([gt_boxes[src, 2] - gt_boxes[src, 0], gt_boxes[src, 3] - gt_boxes[src, 1]] * 2, 1)
    jitter = np.round(rng.uniform(-0.15, 0.15, (len(img), 4)) * size)
    canvas = np.array([COCO_W, COCO_H, COCO_W, COCO_H], np.float64)
    det_boxes = np.where(matched[:, None], np.clip(gt_boxes[src] + jitter, 0, canvas), _coco_boxes(rng, len(img)))
    det_boxes[:, 2:] = np.maximum(det_boxes[:, 2:], det_boxes[:, :2] + 1)
    own_class = (n_g > 0) & (rng.random(len(img)) < 0.5)
    det_labels = np.where(matched | own_class, gt_labels[src], rng.choice(COCO_CLASSES, len(img), p=class_p))
    det_scores = np.where(matched, rng.beta(5, 2, len(img)), rng.beta(2, 5, len(img))).astype(np.float32)
    return {"gt_boxes": gt_boxes, "gt_labels": gt_labels, "gt_counts": g_counts,
            "det_boxes": det_boxes, "det_labels": det_labels, "det_scores": det_scores,
            "det_counts": np.full(n_images, COCO_DETS)}


def _coco_inputs(scene: dict, device, lo: int = 0, hi: Optional[int] = None, masks: Optional[dict] = None):
    """Images ``lo:hi`` of ``scene`` as the dict-per-image lists ``update`` takes: tensors on ``device``
    (a detector's outputs; the gts too), boxes as float32, or COCO RLE dicts in place of boxes."""
    hi = len(scene["gt_counts"]) if hi is None else hi

    def split(key, counts_key, dtype):
        counts = scene[counts_key]
        start = int(counts[:lo].sum())
        stop = start + int(counts[lo:hi].sum())
        flat = torch.as_tensor(np.ascontiguousarray(scene[key][start:stop]), dtype=dtype).to(device)
        return list(torch.split(flat, counts[lo:hi].tolist()))

    preds = [{"scores": s, "labels": lab} for s, lab in zip(split("det_scores", "det_counts", torch.float32),
                                                           split("det_labels", "det_counts", torch.int64))]
    target = [{"labels": lab} for lab in split("gt_labels", "gt_counts", torch.int64)]
    if masks is None:
        for d, b in zip(preds, split("det_boxes", "det_counts", torch.float32)):
            d["boxes"] = b
        for d, b in zip(target, split("gt_boxes", "gt_counts", torch.float32)):
            d["boxes"] = b
    else:
        for side, key in ((preds, "det"), (target, "gt")):
            strings, counts = masks[key], scene[f"{key}_counts"]
            offsets = np.cumsum(np.r_[0, counts])
            for i, d in zip(range(lo, hi), side):
                d["masks"] = [{"size": [COCO_H, COCO_W], "counts": s} for s in strings[offsets[i] : offsets[i + 1]]]
    return preds, target


def _ellipse_runs(boxes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Column-major RLE runs of the ellipse inscribed in each box on the COCO canvas: (runs, runs per mask)."""
    x0, y0, x1, y1 = (boxes[:, i].astype(np.int64) for i in range(4))
    widths = x1 - x0
    mask = np.repeat(np.arange(len(boxes)), widths)
    col = np.arange(int(widths.sum())) - np.repeat(np.cumsum(np.r_[0, widths[:-1]]), widths) + x0[mask]
    cx, cy = (x0 + x1)[mask] / 2, (y0 + y1)[mask] / 2
    a, b = widths[mask] / 2, (y1 - y0)[mask] / 2
    half = b * np.sqrt(np.clip(1 - ((col + 0.5 - cx) / a) ** 2, 0, None))
    top = np.maximum(np.ceil(cy - half - 0.5), y0[mask]).astype(np.int64)
    bottom = np.minimum(np.floor(cy + half - 0.5), y1[mask] - 1).astype(np.int64)
    keep = bottom >= top
    mask, col, top, bottom = mask[keep], col[keep], top[keep], bottom[keep]
    start, end = col * COCO_H + top, col * COCO_H + bottom + 1
    per_mask = np.bincount(mask, minlength=len(boxes))
    first = np.r_[True, mask[1:] != mask[:-1]]
    gaps = np.where(first, start, start - np.r_[0, end[:-1]])
    n_runs = 2 * per_mask + 1  # a 0-run (maybe empty), then (fg, bg) per column, the last bg to the end
    runs = np.zeros(int(n_runs.sum()), np.int64)
    base = np.cumsum(np.r_[0, n_runs[:-1]])
    k = np.arange(len(mask)) - np.repeat(np.cumsum(np.r_[0, per_mask[:-1]]), per_mask)
    runs[base[mask] + 2 * k] = gaps
    runs[base[mask] + 2 * k + 1] = end - start
    last_end = np.zeros(len(boxes), np.int64)
    last_end[mask] = end  # the last interval of each mask wins
    runs[base + n_runs - 1] = COCO_H * COCO_W - last_end
    return runs, n_runs


def _coco_strings(runs: np.ndarray, n_runs: np.ndarray) -> list:
    """pycocotools' compressed RLE strings of many masks at once (the codec of ``rle_to_coco_string``)."""
    starts = np.cumsum(np.r_[0, n_runs[:-1]])
    pos = np.arange(len(runs)) - np.repeat(starts, n_runs)
    x = runs.copy()
    x[pos > 2] -= runs[np.flatnonzero(pos > 2) - 2]
    chars, live = [], np.ones(len(x), bool)
    for _ in range(7):  # a value below 2**31 takes at most 7 five-bit groups
        c = x & 0x1F
        x = x >> 5
        more = np.where((c & 0x10) != 0, x != -1, x != 0) & live
        chars.append(np.where(live, np.where(more, c | 0x20, c) + 48, -1))
        live = more
    table = np.stack(chars, 1).ravel()
    owner = np.repeat(np.repeat(np.arange(len(n_runs)), n_runs), 7)[table >= 0]
    data = table[table >= 0].astype(np.uint8).tobytes()
    bounds = np.r_[0, np.cumsum(np.bincount(owner, minlength=len(n_runs)))]
    return [data[bounds[i] : bounds[i + 1]] for i in range(len(n_runs))]


def _map_pass(mt, preds, target, **kwargs) -> Tuple[dict, dict, float]:
    """One epoch: updates of COCO_BATCH images, then compute(); its values on the host, profile and seconds."""
    metric = mt.MeanAveragePrecision(device=DEVICE, **kwargs)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for lo in range(0, len(preds), COCO_BATCH):
        metric.update(preds[lo : lo + COCO_BATCH], target[lo : lo + COCO_BATCH])
    update_s = time.perf_counter() - start
    out = metric.compute()
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    values = {k: v.cpu().numpy() for k, v in out.items()}
    if any(v.device.type != torch.device(DEVICE).type for v in out.values()):
        raise AssertionError("MeanAveragePrecision.compute() returned tensors off the metric's device")
    prof = {k: (round(v, 6) if isinstance(v, float) else v) for k, v in metric.last_compute_profile.items()}
    prof["update_s"] = update_s
    return values, prof, secs


def _check_routes(name: str, device_vals: dict, host_vals: dict) -> dict:
    """The device route against the native host route: recall (integer TP counts over float64 npig) and
    the classes bitwise, precision-based values within MAP_VALUE_TOL."""
    worst = 0.0
    for key, host in host_vals.items():
        got = device_vals[key]
        if got.shape != host.shape or got.dtype != host.dtype:
            raise AssertionError(f"{name}: {key} is {got.dtype}{got.shape} on the device route, {host.dtype}{host.shape} on the host's")
        if key.startswith("mar") or key == "classes":
            if not np.array_equal(got, host):
                raise AssertionError(f"{name}: {key} differs between the routes: {got} vs {host}")
        else:
            err = float(np.max(np.abs(got.astype(np.float64) - host))) if got.size else 0.0
            if err > MAP_VALUE_TOL:
                raise AssertionError(f"{name}: {key} differs by {err} between the routes (limit {MAP_VALUE_TOL})")
            worst = max(worst, err)
    print(f"{name}: recall bitwise and precision within {worst!r} of the native host route; map {float(host_vals['map'])!r}")
    return {"max_value_err": worst, "map": float(host_vals["map"]), "mar_100": float(host_vals["mar_100"])}


DETECTION_TORCH_OPS = ("segm_intersections", "box_inter_union", "score_tables")  # device.py:87, :146, :241 in the JAX package


def _captured_matches(fn):
    """Run ``fn`` with the device route's calls recorded: the operands of each ``match_ranked_blocks``, and the
    bytes each torch-op stage reads and writes (every input and output tensor counted once)."""
    from metrics_tpu_torch.detection import device as ddev

    seen, moved = [], {name: 0 for name in DETECTION_TORCH_OPS}
    originals = {name: getattr(ddev, name) for name in ("match_ranked_blocks",) + DETECTION_TORCH_OPS}

    def recording(ranks, gt_ignore, thr_ranks):
        seen.append((ranks, gt_ignore, thr_ranks))
        return originals["match_ranked_blocks"](ranks, gt_ignore, thr_ranks)

    def counting(name):
        def call(*args):
            out = originals[name](*args)
            tensors = [t for t in (*args, *(out if isinstance(out, tuple) else (out,))) if isinstance(t, torch.Tensor)]
            moved[name] += sum(t.numel() * t.element_size() for t in tensors)
            return out
        return call

    ddev.match_ranked_blocks = recording
    for name in DETECTION_TORCH_OPS:
        setattr(ddev, name, counting(name))
    try:
        out = fn()
    finally:
        for name, original in originals.items():
            setattr(ddev, name, original)
    return out, seen, moved


def _torch_op_bounds(name: str, moved: dict) -> dict:
    """Each torch-op stage's byte bound: the bytes it must move over the card's memory rate."""
    out = {op: {"bytes": b, "bound_ms": b / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"} for op, b in moved.items() if b}
    print(f"{name}: the torch-op stages' byte bounds {out}")
    return out


def _tie_operands(seed: int, device) -> tuple:
    """Ranks on a grid of five values (ties in every row), padded slots, rows, columns and blocks, more gts
    than a warp's lanes; odd seeds take a threshold rank of -1, which makes padded slots eligible."""
    rng = np.random.default_rng(seed)
    b, d, g = 257, 37, 70
    ranks = rng.integers(0, 5, (b, d, g)).astype(np.int32)
    ranks[rng.random((b, d, g)) < 0.2] = -1
    ranks[:, :, 60:] = -1
    ranks[:, 30:, :] = -1
    ranks[::5] = -1
    gig = rng.random((4, b, g)) < 0.3
    thr = np.sort(rng.integers(-(seed % 2), 5, 10)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (ranks, gig, thr))


def _phase_coco_match(cm, operands: dict, launches: int) -> dict:
    """(d): the kernel bitwise against its plain version on the main path's operands and planted ties; its
    own time, the plain version's, and its bound, on (a)'s operands."""
    compared = 0
    cases = dict(operands)
    for i in range(MATCH_TIE_CASES):
        cases[f"ties{i}"] = _tie_operands(SEED + 140 + i, DEVICE)
    for name, (ranks, gig, thr) in cases.items():
        got = cm.coco_match(ranks, gig, thr)
        want = cm.coco_match_plain(ranks, gig, thr)
        torch.cuda.synchronize()
        if got.dtype != torch.uint8 or not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"coco_match kernel disagrees with its plain version on {name}: {bad} codes")
        compared += got.numel()
        print(f"kernel coco_match on {name} {tuple(ranks.shape)} x {gig.shape[0]} areas x {thr.shape[0]} thresholds: "
              f"bitwise equal to plain")
    ranks, gig, thr = operands["bbox"]
    b, d, g = ranks.shape
    a, t = gig.shape[0], thr.shape[0]
    pairs = int((ranks >= 0).sum())
    kernel = lambda: cm.coco_match(ranks, gig, thr)  # noqa: E731
    ms = _device_ms(kernel, calls=20, per_sleep=10, warmup=3)[0]
    own_ms = _one_launch("coco_match", kernel, calls=5)
    plain_ms = _call_ms(lambda: cm.coco_match_plain(ranks, gig, thr), reps=1, warmup=1)
    # each input read once (the padded rank block, the flags, the thresholds), the codes written once; each
    # (area, threshold) compares, keys and reduces each real (det, gt) pair: about four integer operations
    bytes_moved = ranks.numel() * 4 + gig.numel() + t * 4 + a * b * t * d
    bound_ms, bound_by = _bound(bytes_moved, 4 * a * t * pairs)
    print(f"coco_match on (a)'s operands ({b}, {d}, {g}) ranks, {pairs} real pairs, {a} x {t}: kernel {ms!r} ms "
          f"(its own device time {own_ms!r} ms), plain {plain_ms!r} ms, bound {bound_ms!r} ms ({bound_by}); "
          f"serial chain of {d} steps per (area, block, threshold)")
    return {
        "name": "coco_match",
        "route": "cuda",
        "source": "metrics_tpu_torch/ops/csrc/coco_match.cu",
        "replaces": "metrics_tpu/detection/device.py:177",
        "replaces_kind": "_match_kernel, a lax.fori_loop under jax.vmap (not a Pallas kernel)",
        "launches": launches,
        "bitwise": True,
        "max_abs_err": 0,
        "codes_compared": compared,
        "ms": ms,
        "own_ms": own_ms,
        "ms_shape": f"(a)'s bbox operands: ranks ({b}, {d}, {g}) int32, {a} areas, {t} thresholds",
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "serial_steps": d,
        "library_ms": None,
        "library_note": "no PyTorch call matches greedily",
    }


def _rank_detection(mt, rank: int, out: Path) -> None:
    """(c): this rank's images of each step through forward with dist_sync_on_step, then the epoch compute."""
    scene = _coco_scene(SEED + 142, 2 * COCO_SYNC_STEPS * COCO_SYNC_STEP_IMAGES,
                        round(COCO_GTS * 2 * COCO_SYNC_STEPS * COCO_SYNC_STEP_IMAGES / COCO_IMAGES))
    metric = mt.MeanAveragePrecision(device=DEVICE, dist_sync_on_step=True)
    steps, step_ms = [], []
    for step in range(COCO_SYNC_STEPS):
        lo = (2 * step + rank) * COCO_SYNC_STEP_IMAGES
        preds, target = _coco_inputs(scene, DEVICE, lo, lo + COCO_SYNC_STEP_IMAGES)
        torch.cuda.synchronize()
        start = time.perf_counter()
        value = metric(preds, target)
        step_ms.append((time.perf_counter() - start) * 1e3)
        steps.append({k: v.cpu().numpy().tobytes().hex() for k, v in value.items()})
    start = time.perf_counter()
    final = metric.compute()
    compute_ms = (time.perf_counter() - start) * 1e3
    with metric.sync_context():  # the gathered states stay in host memory too
        synced_on_host = all(t.device.type == "cpu" for t in (metric.detections, metric.detection_scores))
    (out / f"rank{rank}.json").write_text(json.dumps({
        "steps": steps, "final": {k: v.cpu().numpy().tobytes().hex() for k, v in final.items()},
        "step_ms": step_ms, "compute_ms": compute_ms, "profile": metric.last_compute_profile,
        "report": {k: metric.last_sync_report.get(k) for k in ("delta", "bytes_gathered", "world_size")},
        "host_states": synced_on_host and all(t.device.type == "cpu" for t in metric.detections),
    }, default=float))


def phase_detection_sync(mt) -> dict:
    """(c): two gloo ranks on ``cuda:0``; each step's value must be one process's over both ranks' images of
    that step, the epoch's one process's over all 500."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_detection_") as tmp:
        where = Path(tmp) / "detection"
        ranks = _start_ranks("detection", where)
        n = 2 * COCO_SYNC_STEPS * COCO_SYNC_STEP_IMAGES
        scene = _coco_scene(SEED + 142, n, round(COCO_GTS * n / COCO_IMAGES))
        want_steps = []
        for step in range(COCO_SYNC_STEPS):
            lo = 2 * step * COCO_SYNC_STEP_IMAGES
            values, _, _ = _map_pass(mt, *_coco_inputs(scene, DEVICE, lo, lo + 2 * COCO_SYNC_STEP_IMAGES))
            want_steps.append({k: v.tobytes().hex() for k, v in values.items()})
        everything = mt.MeanAveragePrecision(device=DEVICE)
        everything.update(*_coco_inputs(scene, DEVICE))
        want_final = {k: v.cpu().numpy().tobytes().hex() for k, v in everything.compute().items()}
        records = _wait_ranks("detection", ranks, where)
    for rank, record in enumerate(records):
        for step, (got, want) in enumerate(zip(record["steps"], want_steps)):
            if got != want:
                raise AssertionError(f"detection sync: rank {rank}'s step {step} is not one process's over its images")
        if record["final"] != want_final:
            raise AssertionError(f"detection sync: rank {rank}'s epoch value is not one process's")
        prof = record["profile"]
        if not (prof["iou_cache_enabled"] and prof["iou_blocks_new"] == 0 and prof["iou_blocks_cached"] > 0):
            raise AssertionError(f"detection sync: rank {rank}'s epoch compute missed the IoU cache: {prof}")
        if not record["host_states"]:
            raise AssertionError(f"detection sync: rank {rank}'s list states left host memory")
    print(f"detection sync: {COCO_SYNC_STEPS} steps of {2 * COCO_SYNC_STEP_IMAGES} images on two ranks equal one process "
          f"bitwise; epoch compute served {records[0]['profile']['iou_blocks_cached']} blocks from the IoU cache")
    return {
        "images": n, "steps": COCO_SYNC_STEPS, "step_ms_median": [statistics.median(r["step_ms"]) for r in records],
        "compute_ms": [r["compute_ms"] for r in records],
        "iou_cache_hits": [r["profile"]["iou_blocks_cached"] for r in records],
        "epoch_profile": records[0]["profile"], "sync_report": [r["report"] for r in records],
    }


def _image_check(name: str, card_on, card_off, cpu, rtol: float, atol: float) -> dict:
    """The card's value with TF32 allowed and not, each against the CPU's."""
    errs = []
    for tag, got in (("tf32 allowed", card_on), ("tf32 off", card_off)):
        got = got.detach().cpu().to(torch.float64)
        want = cpu.detach().to(torch.float64)
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            raise AssertionError(f"image {name} on the card ({tag}) differs from the CPU by {err}")
        errs.append(err)
    return {"max_abs_err_tf32_on": errs[0], "max_abs_err_tf32_off": errs[1],
            "tf32_bitwise_same": bool(torch.equal(card_on.cpu(), card_off.cpu()))}


def _card_vs_cpu_images(fns: dict, preds: torch.Tensor, target: torch.Tensor, tol: dict) -> dict:
    """Each functional on one batch on the card (TF32 allowed, then not) against the port on the CPU."""
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32
    out = {}
    try:
        for name, fn in fns.items():
            cudnn.allow_tf32 = True
            on = fn(preds, target)
            cudnn.allow_tf32 = False
            off = fn(preds, target)
            cpu = fn(preds.cpu(), target.cpu())
            out[name] = _image_check(name, on, off, cpu, *tol[name])
    finally:
        cudnn.allow_tf32 = before
    return out


def _image_pass(metrics: dict, batch_fn, n_batches: int) -> Tuple[dict, float]:
    """Every batch through every module metric; values and seconds (updates and computes, synchronized;
    the batches are made on the card before the clock starts)."""
    batches = [batch_fn(i) for i in range(n_batches)]
    torch.cuda.synchronize()
    start = time.perf_counter()
    for preds, target in batches:
        for metric in metrics.values():
            metric.update(preds, target)
    values = {name: metric.compute() for name, metric in metrics.items()}
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    for name, value in values.items():
        if not bool(torch.isfinite(value).all()):
            raise AssertionError(f"image {name}: non-finite value {value}")
    return {name: float(v) for name, v in values.items()}, secs


def _div2k_batch(i: int):
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1400 + i)
    shape = (DIV2K_BATCH, 3, DIV2K_H, DIV2K_W)
    target = torch.rand(shape, generator=gen, device=DEVICE)
    return (target + 0.05 * torch.randn(shape, generator=gen, device=DEVICE)).clamp(0, 1), target


def _pan_batch(i: int):
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1500 + i)
    shape = (PAN_BATCH, PAN_BANDS, PAN_SIZE, PAN_SIZE)
    target = 0.1 + 0.9 * torch.rand(shape, generator=gen, device=DEVICE)
    return (target * (1 + 0.05 * torch.randn(shape, generator=gen, device=DEVICE))).clamp(0.05, 1), target


def phase_image(mt) -> dict:
    """(e): a DIV2K-validation-shaped super-resolution pass and a 4-band pan-sharpening pass."""
    from metrics_tpu_torch.functional import image as fi

    sr = {"psnr": mt.PeakSignalNoiseRatio(data_range=1.0, device=DEVICE),
          "ssim": mt.StructuralSimilarityIndexMeasure(data_range=1.0, device=DEVICE),
          "ms_ssim": mt.MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, device=DEVICE),
          "uqi": mt.UniversalImageQualityIndex(device=DEVICE)}
    sr_values, sr_s = _image_pass(sr, _div2k_batch, DIV2K_IMAGES // DIV2K_BATCH)
    pan = {"ergas": mt.ErrorRelativeGlobalDimensionlessSynthesis(ratio=4, device=DEVICE),
           "sam": mt.SpectralAngleMapper(device=DEVICE), "d_lambda": mt.SpectralDistortionIndex(device=DEVICE)}
    pan_values, pan_s = _image_pass(pan, _pan_batch, PAN_PATCHES // PAN_BATCH)
    sr_pixels = DIV2K_IMAGES * DIV2K_H * DIV2K_W
    pan_pixels = (PAN_PATCHES // PAN_BATCH) * PAN_BATCH * PAN_SIZE * PAN_SIZE
    preds, target = _div2k_batch(0)
    conv = (0.0, IMAGE_ATOL)
    sr_checks = _card_vs_cpu_images({
        "psnr": lambda p, t: fi.peak_signal_noise_ratio(p, t, data_range=1.0),
        "ssim": lambda p, t: fi.structural_similarity_index_measure(p, t, data_range=1.0),
        "ms_ssim": lambda p, t: fi.multiscale_structural_similarity_index_measure(p, t, data_range=1.0),
        "uqi": fi.universal_image_quality_index,
    }, preds[:1], target[:1], {"psnr": (IMAGE_RTOL, 0.0), "ssim": conv, "ms_ssim": conv, "uqi": conv})
    preds, target = _pan_batch(0)
    pan_checks = _card_vs_cpu_images({
        "ergas": lambda p, t: fi.error_relative_global_dimensionless_synthesis(p, t, ratio=4),
        "sam": fi.spectral_angle_mapper, "d_lambda": fi.spectral_distortion_index,
    }, preds[:4], target[:4], {"ergas": (IMAGE_RTOL, 0.0), "sam": (IMAGE_RTOL, 0.0), "d_lambda": conv})
    print(f"image: super-resolution {sr_values} at {sr_pixels / sr_s!r} pixels/s through four metrics; "
          f"pan-sharpening {pan_values} at {pan_pixels / pan_s!r} pixels/s through three; the card within tolerance "
          f"of the CPU with TF32 allowed and not")
    return {
        "super_resolution": {"images": DIV2K_IMAGES, "shape": [3, DIV2K_H, DIV2K_W], "batch": DIV2K_BATCH,
                             "values": sr_values, "seconds": sr_s, "pixels_per_s": sr_pixels / sr_s,
                             "card_vs_cpu": sr_checks},
        "pan_sharpening": {"patches": PAN_PATCHES // PAN_BATCH * PAN_BATCH, "shape": [PAN_BANDS, PAN_SIZE, PAN_SIZE],
                           "batch": PAN_BATCH, "values": pan_values, "seconds": pan_s,
                           "pixels_per_s": pan_pixels / pan_s, "card_vs_cpu": pan_checks},
    }


def phase_detection_image(mt, card: str) -> Tuple[dict, dict]:
    """Phase 14: (a) COCO-val-shaped bbox mAP on both routes, (b) segm from COCO RLE strings, (c) two ranks
    with dist_sync_on_step, (d) the coco_match kernel against its plain version, (e) image metrics.
    Returns the kernels-line entry of coco_match and the phase line."""
    from metrics_tpu_torch.ops import coco_match as cm

    phase_start = time.perf_counter()
    scene = _coco_scene(SEED + 141, COCO_IMAGES, COCO_GTS)
    preds, target = _coco_inputs(scene, DEVICE)
    cm.coco_match.launches = 0
    (dev_vals, dev_prof, dev_s), operands, moved = _captured_matches(
        lambda: _map_pass(mt, preds, target, on_device=True, class_metrics=True))
    launches = cm.coco_match.launches
    host_vals, host_prof, host_s = _map_pass(mt, preds, target, on_device=False, class_metrics=True)
    if launches != len(operands) or launches < 1:
        raise AssertionError(f"the bbox device route launched coco_match {launches} times for {len(operands)} matches")
    bbox = {"images": COCO_IMAGES, "gts": COCO_GTS, "dets": COCO_IMAGES * COCO_DETS, "batch": COCO_BATCH,
            "device_route": {"seconds": dev_s, "images_per_s": COCO_IMAGES / dev_s, "profile": dev_prof},
            "host_route": {"seconds": host_s, "images_per_s": COCO_IMAGES / host_s, "profile": host_prof},
            "torch_op_bounds": _torch_op_bounds("bbox", moved), **_check_routes("bbox", dev_vals, host_vals)}
    print(f"bbox: device route {COCO_IMAGES / dev_s!r} images/s ({dev_prof}), host route {COCO_IMAGES / host_s!r} "
          f"images/s ({host_prof})")
    del preds, target

    setup = time.perf_counter()
    n_det = COCO_SEGM_IMAGES * COCO_DETS
    n_gt = int(scene["gt_counts"][:COCO_SEGM_IMAGES].sum())
    strings = {"det": _coco_strings(*_ellipse_runs(scene["det_boxes"][:n_det])),
               "gt": _coco_strings(*_ellipse_runs(scene["gt_boxes"][:n_gt]))}
    setup_s = time.perf_counter() - setup
    preds, target = _coco_inputs(scene, DEVICE, 0, COCO_SEGM_IMAGES, masks=strings)
    before = cm.coco_match.launches
    (seg_vals, seg_prof, seg_s), seg_ops, seg_moved = _captured_matches(
        lambda: _map_pass(mt, preds, target, iou_type="segm", on_device=True, class_metrics=True))
    launches += cm.coco_match.launches - before
    seg_host_vals, seg_host_prof, seg_host_s = _map_pass(mt, preds, target, iou_type="segm", on_device=False,
                                                         class_metrics=True)
    segm = {"images": COCO_SEGM_IMAGES, "masks": n_det + n_gt, "encode_setup_s": setup_s,
            "cut": f"{COCO_SEGM_IMAGES} of {COCO_IMAGES} images: the masks' RLE strings are encoded on the host in setup",
            "device_route": {"seconds": seg_s, "images_per_s": COCO_SEGM_IMAGES / seg_s, "profile": seg_prof},
            "host_route": {"seconds": seg_host_s, "images_per_s": COCO_SEGM_IMAGES / seg_host_s, "profile": seg_host_prof},
            "torch_op_bounds": _torch_op_bounds("segm", seg_moved), **_check_routes("segm", seg_vals, seg_host_vals)}
    print(f"segm: device route {COCO_SEGM_IMAGES / seg_s!r} images/s ({seg_prof}), host route "
          f"{COCO_SEGM_IMAGES / seg_host_s!r} images/s ({seg_host_prof}); {n_det + n_gt} masks encoded in {setup_s!r} s")
    del preds, target, scene

    sync = phase_detection_sync(mt)
    entry = _phase_coco_match(cm, {"bbox": operands[0], "segm": seg_ops[0]}, launches)
    del operands, seg_ops
    torch.cuda.empty_cache()
    image = phase_image(mt)
    secs = time.perf_counter() - phase_start
    print(f"detection_image phase took {secs:.1f} s")
    line = {"detection_image": {"card": card, "bbox": bbox, "segm": segm, "sync": sync,
                                "coco_match_launches": launches, "image": image, "phase_s": secs}}
    return entry, line

# ---------------------------------------------------------------------------------------------------------------
# Phase 15: FID, KID, IS and LPIPS on their extractors, and the WER family
# ---------------------------------------------------------------------------------------------------------------
GEN_IMAGES, GEN_SIDE, GEN_BATCH = 10_000, 32, 100  # CIFAR-10 test: 10,000 RGB images of 32 x 32; a caller's batch
GEN_CHUNK = 500  # extractor_batch of the chunked runs
GEN_CPU_IMAGES = 16  # the card-against-CPU feature check (the CPU runs Inception at 299 x 299)
GEN_SYNC_BATCHES = GEN_IMAGES // GEN_BATCH // 4  # (c): each rank a quarter of (a)'s batches of each set, the two
# ranks together its first half
KID_SUBSETS, KID_SUBSET_SIZE = 100, 1000  # KID's defaults
IS_SPLITS = 10
LPIPS_PAIRS, LPIPS_SIDE, LPIPS_BATCH = 5_000, 64, 50  # BAPPS patches are 64 x 64; pairs cut to the phase's budget
LPIPS_NETS = ("alex", "vgg", "squeeze")
LPIPS_CPU_PAIRS = 4
LIBRI_UTTERANCES, LIBRI_BATCH = 2_620, 32  # LibriSpeech test-clean: 2,620 utterances
LIBRI_VOCAB = 8_000
LIBRI_EDIT_RATE = 0.05  # substitutions, insertions and deletions together, per reference word
# the card against the CPU, and the batch against the chunked runs: Inception features to the parity tests'
# tolerance (float32 through ~95 convolutions summed in other orders); FID within a share of the magnitudes of
# the terms its formula sums (the float32 eigh of a 2048 x 2048 covariance on the card carries ~1e-3 of them in
# the square roots of its small eigenvalues: 8.3e-4 against the CPU's 6.8e-5 in tools/inception_probe.py),
# KID within a share of its kernel sums' scale (the kernel values are about 1 here), IS's mean relative and its
# deviation within that share of the mean
FEATURE_RTOL, FEATURE_ATOL = 1e-4, 1e-5
FID_TERM_SHARE = 5e-3
KID_ATOL = 1e-5
IS_RTOL = 1e-5
LPIPS_RTOL, LPIPS_ATOL = 1e-4, 1e-6


def _gen_batch(real: bool, i: int) -> torch.Tensor:
    """Batch ``i`` of (a)'s real or generated images, made on the card from the seed (any rank makes the same)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1600 + (0 if real else 100_000) + i)
    shape = (GEN_BATCH, 3, GEN_SIDE, GEN_SIDE)
    base = torch.randint(0, 256, shape, generator=gen, device=DEVICE, dtype=torch.int32)
    if real:
        return base.to(torch.uint8)
    noise = torch.randint(-24, 25, shape, generator=gen, device=DEVICE, dtype=torch.int32)
    return (base * 7 // 8 + 16 + noise).clamp(0, 255).to(torch.uint8)  # a generator's blurred, shifted copy


def _gen_pass(metric, sides, n_batches: int, lo: int = 0, snapshots: Optional[dict] = None):
    """Batches ``lo .. lo + n_batches`` of each set in ``sides`` (``None``: the generated set, unlabelled)
    through ``metric``, then its value: ``(value, seconds of the whole pass, ms of the compute)``, synchronized.
    ``snapshots`` maps batch counts to None: each is set to a clone of the metric after that many batches."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    for i in range(lo, lo + n_batches):
        for real in sides:
            if real is None:
                metric.update(_gen_batch(False, i))
            else:
                metric.update(_gen_batch(real, i), real)
        if snapshots is not None and i + 1 - lo in snapshots:
            snapshots[i + 1 - lo] = metric.clone()
    torch.cuda.synchronize()
    mid = time.perf_counter()
    value = metric.compute()
    torch.cuda.synchronize()
    end = time.perf_counter()
    return value, end - start, (end - mid) * 1e3


def _scores(value) -> list:
    return [float(v) for v in (value if isinstance(value, tuple) else (value,))]


def _score_bits(value) -> list:
    return [v.cpu().numpy().tobytes().hex() for v in (value if isinstance(value, tuple) else (value,))]


def _fid_reference(metric) -> Tuple[float, float]:
    """FID from the metric's states in float64 on the host (the same formula), and its tolerance: a share of
    the magnitudes of the terms the formula cancels, ``|mu1 - mu2|^2 + tr S1 + tr S2 + 2 tr sqrt(S1 S2)``."""
    from metrics_tpu_torch.image.fid import FrechetInceptionDistance, _trace_sqrt_product

    states = {k: v.detach().cpu().double() for k, v in metric.state_pytree().items() if isinstance(v, torch.Tensor)}
    mu1, s1 = FrechetInceptionDistance._mean_cov(states["real_sum"], states["real_outer"], states["real_n"])
    mu2, s2 = FrechetInceptionDistance._mean_cov(states["fake_sum"], states["fake_outer"], states["fake_n"])
    diff = float((mu1 - mu2) @ (mu1 - mu2))
    tr1, tr2, cross = float(torch.trace(s1)), float(torch.trace(s2)), float(_trace_sqrt_product(s1, s2))
    return diff + tr1 + tr2 - 2 * cross, FID_TERM_SHARE * (abs(diff) + abs(tr1) + abs(tr2) + 2 * abs(cross))


def _check_scores(name: str, got: list, want: list, kind: str, slack: float = 0.0) -> float:
    """``got`` against ``want`` (FID, KID or IS values) by the kind's tolerance; the largest difference."""
    diffs = [abs(g - w) for g, w in zip(got, want)]
    if kind == "fid":
        ok = diffs[0] <= slack
    elif kind == "kid":
        ok = all(d <= KID_ATOL for d in diffs)
    else:
        ok = diffs[0] <= IS_RTOL * abs(want[0]) and diffs[1] <= IS_RTOL * abs(want[0])
    if not ok or not all(np.isfinite(got)):
        raise AssertionError(f"{name}: {got} against {want} (differences {diffs}, FID slack {slack})")
    return max(diffs)


def _extractor_ms(extractor, batch: torch.Tensor, reps: int = 3) -> float:
    """Device ms per image of one extractor call on ``batch`` (warm, CUDA events, median of ``reps``)."""
    extractor(batch)
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        extractor(batch)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times) / batch.shape[0]


def phase_generation(mt) -> Tuple[dict, dict]:
    """(a): FID, KID and IS over CIFAR-10 test-shaped real and generated sets through the built-in Inception.
    Returns the line's entry and the single-process values that (c) is held to."""
    from metrics_tpu_torch.image.backbones import InceptionFeatureExtractor

    n_batches = GEN_IMAGES // GEN_BATCH
    out, single = {}, {}
    specs = {
        "fid": (lambda **kw: mt.FrechetInceptionDistance(feature=2048, device=DEVICE, **kw), (True, False)),
        "kid": (lambda **kw: mt.KernelInceptionDistance(feature=2048, subsets=KID_SUBSETS, subset_size=KID_SUBSET_SIZE,
                                                        device=DEVICE, **kw), (True, False)),
        "is": (lambda **kw: mt.InceptionScore(feature="logits_unbiased", splits=IS_SPLITS, device=DEVICE, **kw), (None,)),
    }
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # random init: "no converted weights installed"
        for name, (make, sides) in specs.items():
            runs = {}
            for tag, kwargs in (("batch", {}), ("chunked", {"extractor_batch": GEN_CHUNK})):
                metric = make(**kwargs)
                # (c)'s one process: the first half of each set, the batches the two ranks take
                half = {2 * GEN_SYNC_BATCHES: None} if tag == "batch" and name != "is" else None
                value, secs, compute_ms = _gen_pass(metric, sides, n_batches, snapshots=half)
                if half is not None:
                    sync_value = half[2 * GEN_SYNC_BATCHES].compute()
                    single[name + "_half"], single[name + "_half_bits"] = _scores(sync_value), _score_bits(sync_value)
                    if name == "fid":
                        single["fid_half_slack"] = _fid_reference(half[2 * GEN_SYNC_BATCHES])[1]
                    del half
                images = n_batches * GEN_BATCH * len(sides)
                runs[tag] = {"value": _scores(value), "seconds": secs, "images_per_s": images / secs,
                             "compute_ms": compute_ms}
                if tag == "batch":
                    single[name], single[name + "_bits"] = _scores(value), _score_bits(value)
                    if name == "fid":
                        fid = metric
                        reference, single["fid_slack"] = _fid_reference(metric)
                        _check_scores("FID against its float64 reference", single["fid"], [reference], "fid",
                                      single["fid_slack"])
                        runs["float64_reference"] = reference
                del metric
            runs["chunked_vs_batch"] = _check_scores(f"{name} chunked against the caller's batch",
                                                     runs["chunked"]["value"], runs["batch"]["value"], name,
                                                     single.get("fid_slack", 0.0))
            out[name] = runs
            print(f"{name}: {runs['batch']['value']} at {runs['batch']['images_per_s']!r} images/s (caller's batch "
                  f"{GEN_BATCH}), {runs['chunked']['images_per_s']!r} (extractor_batch {GEN_CHUNK}); compute "
                  f"{runs['batch']['compute_ms']!r} ms")
        bf16 = mt.FrechetInceptionDistance(feature=2048, extractor_dtype=torch.bfloat16, device=DEVICE)
        value, secs, _ = _gen_pass(bf16, (True, False), n_batches)
        out["fid_bf16"] = {"value": float(value), "seconds": secs, "images_per_s": 2 * GEN_IMAGES / secs,
                           "relative_to_float32": float(value) / single["fid"][0] - 1}
        print(f"fid bf16: {float(value)!r} at {out['fid_bf16']['images_per_s']!r} images/s")
        del bf16
        # the card against the CPU: one batch's features, and FID from the same states
        batch = _gen_batch(True, 0)
        card = fid.extractor(batch[:GEN_CPU_IMAGES]).cpu()
        cpu_extractor = InceptionFeatureExtractor("2048", device="cpu")
        cpu = cpu_extractor(batch[:GEN_CPU_IMAGES].cpu())
        err = float((card - cpu).abs().max())
        if not torch.allclose(card, cpu, rtol=FEATURE_RTOL, atol=FEATURE_ATOL):
            raise AssertionError(f"Inception features on the card differ from the CPU's by {err}")
        cpu_fid = mt.FrechetInceptionDistance(feature=cpu_extractor, feature_dim=2048, device="cpu")
        cpu_fid.load_state_pytree({k: v.cpu() if isinstance(v, torch.Tensor) else v
                                   for k, v in fid.state_pytree().items()})
        cpu_value = float(cpu_fid.compute())
        fid_err = _check_scores("FID on the CPU from the card's states", [cpu_value], single["fid"], "fid",
                                single["fid_slack"])
        out["card_vs_cpu"] = {"features_max_abs_err": err, "fid_cpu": cpu_value, "fid_abs_err": fid_err,
                              "fid_slack": single["fid_slack"]}
        print(f"generation: features on the card within {err!r} of the CPU's; FID from the same states on the CPU "
              f"{cpu_value!r} (card {single['fid'][0]!r}, slack {single['fid_slack']!r})")
        per_image = {}
        for tag, size, dtype in (("float32_batch", GEN_BATCH, None), ("float32_chunk", GEN_CHUNK, None),
                                 ("bf16_chunk", GEN_CHUNK, torch.bfloat16)):
            extractor = fid.extractor if dtype is None else InceptionFeatureExtractor("2048", compute_dtype=dtype,
                                                                                      device=DEVICE)
            images = torch.cat([_gen_batch(True, i) for i in range(size // GEN_BATCH)])
            per_image[tag] = _extractor_ms(extractor, images)
        out["extractor_ms_per_image"] = per_image
        print(f"extractor ms per image: {per_image}")
    line = {"images": GEN_IMAGES, "shape": [3, GEN_SIDE, GEN_SIDE], "batch": GEN_BATCH, "chunk": GEN_CHUNK, **out,
            "fid_compute_ms": out["fid"]["batch"]["compute_ms"]}
    return line, single


def _lpips_batch(i: int) -> Tuple[torch.Tensor, torch.Tensor]:
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1700 + i)
    shape = (LPIPS_BATCH, 3, LPIPS_SIDE, LPIPS_SIDE)
    ref = torch.rand(shape, generator=gen, device=DEVICE) * 2 - 1
    return ref, (ref + 0.2 * torch.randn(shape, generator=gen, device=DEVICE)).clamp(-1, 1)


def phase_lpips(mt) -> dict:
    """(b): BAPPS-shaped patch pairs through LPIPS on each built-in net."""
    n_batches = LPIPS_PAIRS // LPIPS_BATCH
    batches = [_lpips_batch(i) for i in range(n_batches)]
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        for net_type in LPIPS_NETS:
            metric = mt.LearnedPerceptualImagePatchSimilarity(net_type=net_type, device=DEVICE)
            torch.cuda.synchronize()
            start = time.perf_counter()
            for a, b in batches:
                metric.update(a, b)
            value = float(metric.compute())
            torch.cuda.synchronize()
            secs = time.perf_counter() - start
            cpu = mt.LearnedPerceptualImagePatchSimilarity(net_type=net_type, device="cpu")
            a, b = batches[0]
            card = metric._net(a[:LPIPS_CPU_PAIRS], b[:LPIPS_CPU_PAIRS]).cpu()
            want = cpu._net(a[:LPIPS_CPU_PAIRS].cpu(), b[:LPIPS_CPU_PAIRS].cpu())
            err = float((card - want).abs().max())
            if not np.isfinite(value) or not torch.allclose(card, want, rtol=LPIPS_RTOL, atol=LPIPS_ATOL):
                raise AssertionError(f"lpips {net_type}: {value}; the card's distances differ from the CPU's by {err}")
            out[net_type] = {"value": value, "seconds": secs, "pairs_per_s": LPIPS_PAIRS / secs, "card_vs_cpu": err}
            print(f"lpips {net_type}: {value!r} at {LPIPS_PAIRS / secs!r} pairs/s; the card within {err!r} of the CPU")
    return {"pairs": LPIPS_PAIRS, "side": LPIPS_SIDE, "batch": LPIPS_BATCH, **out}


def _rank_generation(mt, rank: int, out: Path) -> None:
    """(c): this rank's quarter of (a)'s batches of each set through FID and KID, synced at compute."""
    record = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        for name, metric in (("fid", mt.FrechetInceptionDistance(feature=2048, device=DEVICE)),
                             ("kid", mt.KernelInceptionDistance(feature=2048, subsets=KID_SUBSETS,
                                                                subset_size=KID_SUBSET_SIZE, device=DEVICE))):
            value, secs, compute_ms = _gen_pass(metric, (True, False), GEN_SYNC_BATCHES, rank * GEN_SYNC_BATCHES)
            report = metric.last_sync_report or {}
            record[name] = {"value": _scores(value), "bits": _score_bits(value), "seconds": secs,
                            "compute_ms": compute_ms, "bytes_gathered": report.get("bytes_gathered"),
                            "world_size": report.get("world_size")}
    (out / f"rank{rank}.json").write_text(json.dumps(record))


def phase_generation_sync(single: dict) -> dict:
    """(c): FID and KID over two gloo ranks on ``cuda:0``, together the first half of (a)'s batches of each set;
    equal to one process over them (a snapshot of (a)'s pass)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_generation_") as tmp:
        where = Path(tmp) / "generation"
        start = time.perf_counter()
        records = _wait_ranks("generation", _start_ranks("generation", where), where)
        secs = time.perf_counter() - start
    for rank, record in enumerate(records):
        if record["fid"]["world_size"] != SYNC_WORLD or record["kid"]["world_size"] != SYNC_WORLD:
            raise AssertionError(f"generation sync: rank {rank} did not sync over {SYNC_WORLD} ranks: {record}")
        _check_scores(f"FID synced on rank {rank}", record["fid"]["value"], single["fid_half"], "fid",
                      single["fid_half_slack"])
        _check_scores(f"KID synced on rank {rank}", record["kid"]["value"], single["kid_half"], "kid")
    kid_bitwise = all(r["kid"]["bits"] == single["kid_half_bits"] for r in records)
    print(f"generation sync: FID and KID over two ranks equal one process (KID bitwise: {kid_bitwise}); "
          f"KID gathered {records[0]['kid']['bytes_gathered']} bytes a rank; {secs:.1f} s with the ranks' start")
    return {"images_per_rank": 2 * GEN_SYNC_BATCHES * GEN_BATCH, "seconds": secs, "kid_bitwise": kid_bitwise,
            "one_process": {"fid": single["fid_half"], "kid": single["kid_half"]}, "ranks": records}


def _libri_corpus() -> Tuple[list, list, dict]:
    """LibriSpeech test-clean-shaped pairs: references of 1-80 words (about 20 on average) over a Zipf
    vocabulary, hypotheses with substitutions, insertions and deletions at ``LIBRI_EDIT_RATE`` in all."""
    rng = np.random.default_rng(SEED + 1800)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz'"))
    vocab = ["".join(rng.choice(letters[:26], size=int(rng.integers(1, 11)))) for _ in range(LIBRI_VOCAB)]
    weights = 1.0 / np.arange(1, LIBRI_VOCAB + 1)
    weights /= weights.sum()
    preds, target = [], []
    edits = {"sub": 0, "ins": 0, "del": 0, "words": 0}
    for _ in range(LIBRI_UTTERANCES):
        n = int(np.clip(rng.lognormal(np.log(17.0), 0.6), 1, 80))
        ref = [vocab[i] for i in rng.choice(LIBRI_VOCAB, size=n, p=weights)]
        hyp = []
        for word in ref:
            u = rng.random()
            if u < LIBRI_EDIT_RATE / 3:
                hyp.append(vocab[int(rng.integers(LIBRI_VOCAB))])
                edits["sub"] += 1
            elif u < 2 * LIBRI_EDIT_RATE / 3:
                edits["del"] += 1
            else:
                hyp.append(word)
            if rng.random() < LIBRI_EDIT_RATE / 3:
                hyp.append(vocab[int(rng.integers(LIBRI_VOCAB))])
                edits["ins"] += 1
        edits["words"] += n
        preds.append(" ".join(hyp))
        target.append(" ".join(ref))
    return preds, target, edits


def _levenshtein(a: list, b: list) -> int:
    """A plain dynamic program, the independent reference of the native edit distance."""
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, y in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (x != y))
        prev = cur
    return prev[-1]


def _text_collection(mt, device: str):
    return mt.MetricCollection({"wer": mt.WordErrorRate(device=device), "cer": mt.CharErrorRate(device=device),
                                "mer": mt.MatchErrorRate(device=device), "wil": mt.WordInfoLost(device=device),
                                "wip": mt.WordInfoPreserved(device=device)}, device=device)


def _updates_issue_no_device_operation(col, batches) -> Optional[int]:
    """The collection's updates issue no device operation (see :func:`_issues_no_device_operation`)."""

    def run():
        for preds, target in batches:
            col.update(preds, target)

    return _issues_no_device_operation("text", run)


def _libri_batches() -> Tuple[list, list, list, dict]:
    preds, target, edits = _libri_corpus()
    batches = [(preds[i : i + LIBRI_BATCH], target[i : i + LIBRI_BATCH]) for i in range(0, len(preds), LIBRI_BATCH)]
    return preds, target, batches, edits


def _text_update_profile(mt) -> Optional[int]:
    """(d)'s profile of the WER family's updates on the card (see :func:`_updates_issue_no_device_operation`).
    ``main`` takes it early: profiler sessions after the curve phase lose events."""
    _, _, batches, _ = _libri_batches()
    col = _text_collection(mt, DEVICE)
    col.update(*batches[0])  # the first update forms the compute groups
    seen = _updates_issue_no_device_operation(col, batches[1:])
    if not all(m._host_buffers_dirty for m in col.values()):  # no state was written: the sums wait on the host
        raise AssertionError("text: an update wrote a state on the card")
    return seen


def phase_text(mt, device_ops: Optional[int]) -> dict:
    """(d): LibriSpeech test-clean-shaped transcripts through the WER family in one collection.
    ``device_ops`` is :func:`_text_update_profile`'s result."""
    preds, target, batches, edits = _libri_batches()
    col = _text_collection(mt, DEVICE)
    col.update(*batches[0])  # the first update forms the compute groups
    start = time.perf_counter()
    for p, t in batches[1:]:
        col.update(p, t)
    values = col.compute()
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    if not all(v.device.type == torch.device(DEVICE).type for v in values.values()):
        raise AssertionError("text: values left the card")
    cpu = _text_collection(mt, "cpu")
    for p, t in batches:
        cpu.update(p, t)
    cpu_values = cpu.compute()
    for name, value in values.items():
        if value.cpu().numpy().tobytes() != cpu_values[name].numpy().tobytes():
            raise AssertionError(f"text {name}: the card's {float(value)} is not the CPU's {float(cpu_values[name])}")
    errors = sum(_levenshtein(p.split(), t.split()) for p, t in zip(preds, target))
    words = sum(len(t.split()) for t in target)
    if float(values["wer"]) != float(np.float32(errors) / np.float32(words)):
        raise AssertionError(f"text: WER {float(values['wer'])} against a plain edit distance's {errors / words}")
    chars = 200
    char_errors = sum(_levenshtein(list(p), list(t)) for p, t in zip(preds[:chars], target[:chars]))
    char_total = sum(len(t) for t in target[:chars])
    if float(mt.char_error_rate(preds[:chars], target[:chars])) != float(np.float32(char_errors) / np.float32(char_total)):
        raise AssertionError("text: CER of the first utterances against a plain edit distance's")
    profiled = "not profiled" if device_ops is None else "no device operation (the profiler saw its canary alone)"
    print(f"text: {({k: float(v) for k, v in values.items()})} at {LIBRI_UTTERANCES / secs!r} utterances/s; the "
          f"card's values bitwise the CPU's; WER {errors}/{words} as a plain edit distance; the updates: {profiled}; "
          f"groups {col.compute_groups}")
    return {"utterances": LIBRI_UTTERANCES, "words": words, "batch": LIBRI_BATCH, "edits_applied": edits,
            "values": {k: float(v) for k, v in values.items()}, "seconds": secs,
            "utterances_per_s": LIBRI_UTTERANCES / secs, "device_ops_in_updates": 0 if device_ops else None,
            "compute_groups": {str(k): v for k, v in col.compute_groups.items()}}


def phase_generation_text(mt, card: str, text_profile: Optional[int] = None) -> dict:
    """Phase 15: (a) FID, KID and IS on CIFAR-10 test-shaped sets, (b) LPIPS on BAPPS-shaped patches, (c) FID and
    KID over two gloo ranks, (d) the WER family on LibriSpeech test-clean-shaped transcripts.  ``text_profile``
    is :func:`_text_update_profile`'s result where ``main`` took it early, else (d) takes it."""
    phase_start = time.perf_counter()
    generation, single = phase_generation(mt)
    torch.cuda.empty_cache()
    lpips = phase_lpips(mt)
    torch.cuda.empty_cache()
    sync = phase_generation_sync(single)
    text = phase_text(mt, _text_update_profile(mt) if text_profile is None else text_profile)
    secs = time.perf_counter() - phase_start
    print(f"generation_text phase took {secs:.1f} s")
    return {"generation_text": {"card": card, "generation": generation, "lpips": lpips, "sync": sync, "text": text,
                                "phase_s": secs}}


WMT_SEGMENTS = 3_000  # a WMT newstest set: one reference a segment
WMT_BATCH = 100
WMT_VOCAB = 32_000
WMT_WORDS = (15, 40)  # a segment's words, uniform
CNNDM_PAIRS = 11_490  # the CNN/DailyMail test split
CNNDM_BATCH = 100
CNNDM_WORDS = 56  # about this many words a summary, in 3 or 4 newline-separated sentences
SQUAD_QUESTIONS = 10_570  # SQuAD v1.1 dev
SQUAD_BATCH = 500
BERT_SHAPE = {"layers": 24, "hidden": 1024, "heads": 16, "ffn": 4096, "vocab": 50_265, "positions": 514}  # roberta-large
BERT_NUM_LAYERS = 17  # the reference's layer for roberta-large
BERT_MAX_LENGTH = 128
BERT_BATCH = 64
BERT_PAIRS = 1_000  # (a)'s first segments, in (a)'s batches
BERT_SIDE_PAIRS = 64  # the idf and all_layers runs
BERT_CPU_PAIRS = 16  # the card against the CPU port
BERT_CPU_ATOL = 1e-4  # precision, recall and F1: a float32 encoder of 24 layers on two devices
MATCH_ATOL = 1e-6  # the greedy matching from identical embeddings on the card and the CPU
WSJ_PAIRS = 3_000  # WSJ0-2mix's test mixtures
WSJ_SAMPLES = 32_000  # 4 s at 8 kHz
WSJ_BATCH = 16
SDR_FILTER = 512
PIT_MIXTURES = {2: 1_500, 3: 1_000, 8: 48}  # speakers: mixtures (8 takes the host LAP)
AUDIO_CPU_BATCHES = 2  # (d)'s batches the CPU port scores again
SNR_ATOL_DB = 1e-4  # SNR, SI-SNR, SI-SDR: float32 sums of 32,000 squares added in another order
SDR_ATOL_DB = 2e-3  # SDR: and a float32 solve of 512 taps
SDR64_ATOL_DB = 2e-3  # SDR against a float64 solve of the same system


def _zipf_vocab(rng: np.random.Generator, size: int) -> Tuple[list, np.ndarray]:
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = ["".join(rng.choice(letters, size=int(rng.integers(1, 11)))) for _ in range(size)]
    weights = 1.0 / np.arange(1, size + 1)
    return vocab, np.cumsum(weights / weights.sum())


def _draw(rng: np.random.Generator, vocab: list, cdf: np.ndarray, n: int) -> list:
    return [vocab[i] for i in np.minimum(np.searchsorted(cdf, rng.random(n)), len(vocab) - 1)]


@lru_cache(maxsize=1)
def _wmt_corpus() -> Tuple[list, list]:
    """Newstest-shaped segments: references of 15-40 Zipf words with commas and a full stop, and
    hypotheses with 15 % substitutions, 5 % deletions, 5 % insertions and a moved phrase in three of ten."""
    rng = np.random.default_rng(SEED + 1900)
    vocab, cdf = _zipf_vocab(rng, WMT_VOCAB)
    preds, target = [], []
    for _ in range(WMT_SEGMENTS):
        ref = _draw(rng, vocab, cdf, int(rng.integers(WMT_WORDS[0], WMT_WORDS[1] + 1)))
        ref = [w + "," if rng.random() < 0.06 else w for w in ref]
        hyp = []
        for word in ref:
            u = rng.random()
            if u < 0.15:
                hyp.append(_draw(rng, vocab, cdf, 1)[0])
            elif u >= 0.20:
                hyp.append(word)
            if rng.random() < 0.05:
                hyp.append(_draw(rng, vocab, cdf, 1)[0])
        if len(hyp) > 6 and rng.random() < 0.3:
            at, span = int(rng.integers(0, len(hyp) - 4)), int(rng.integers(2, 5))
            phrase = hyp[at : at + span]
            del hyp[at : at + span]
            to = int(rng.integers(0, len(hyp) + 1))
            hyp[to:to] = phrase
        preds.append(" ".join(hyp).capitalize() + ".")
        target.append(" ".join(ref).capitalize() + ".")
    return preds, target


def _cnndm_corpus() -> Tuple[list, list]:
    """CNN/DailyMail-shaped pairs: summaries of about 56 words in 3-4 newline-separated sentences; the
    candidate shares about half its words with the reference."""
    rng = np.random.default_rng(SEED + 1901)
    vocab, cdf = _zipf_vocab(rng, WMT_VOCAB)

    def summary(words: list) -> str:
        cuts = np.sort(rng.choice(np.arange(3, len(words) - 2), size=int(rng.integers(2, 4)), replace=False))
        return "\n".join(" ".join(part).capitalize() + "." for part in np.split(np.array(words, dtype=object), cuts))

    preds, target = [], []
    for _ in range(CNNDM_PAIRS):
        ref = _draw(rng, vocab, cdf, max(12, int(rng.normal(CNNDM_WORDS, 10))))
        fresh = _draw(rng, vocab, cdf, len(ref))
        cand = [r if rng.random() < 0.5 else f for r, f in zip(ref, fresh)]
        preds.append(summary(cand))
        target.append(summary(ref))
    return preds, target


def _squad_corpus() -> Tuple[list, list]:
    """SQuAD v1.1 dev-shaped questions: 1-3 answers of 1-6 words each; predictions that match an answer,
    overlap one, or miss."""
    rng = np.random.default_rng(SEED + 1902)
    vocab, cdf = _zipf_vocab(rng, WMT_VOCAB)
    preds, target = [], []
    for q in range(SQUAD_QUESTIONS):
        answers = [" ".join(_draw(rng, vocab, cdf, int(rng.integers(1, 7)))) for _ in range(int(rng.integers(1, 4)))]
        target.append({"answers": {"answer_start": [0] * len(answers), "text": answers}, "id": f"q{q}"})
        u, base = rng.random(), answers[int(rng.integers(0, len(answers)))].split()
        if u < 0.6:
            text = " ".join(base)
        elif u < 0.9:
            text = " ".join(base[: max(1, len(base) - 1)] + _draw(rng, vocab, cdf, 2))
        else:
            text = " ".join(_draw(rng, vocab, cdf, 3))
        preds.append({"prediction_text": "The " + text if rng.random() < 0.1 else text, "id": f"q{q}"})
    return preds, target


def _mt_metrics(mt, device: str) -> dict:
    return {"bleu": mt.BLEUScore(device=device), "sacrebleu": mt.SacreBLEUScore(tokenize="13a", device=device),
            "chrf++": mt.CHRFScore(device=device), "ter": mt.TranslationEditRate(device=device),
            "eed": mt.ExtendedEditDistance(device=device)}


def _summary_metrics(mt, device: str) -> dict:
    return {"rouge": mt.ROUGEScore(rouge_keys=("rouge1", "rouge2", "rougeL", "rougeLsum"), device=device),
            "squad": mt.SQuAD(device=device)}


@lru_cache(maxsize=1)
def _text_batches() -> dict:
    """(a)'s and (b)'s batches: each metric's name to its list of (preds, target)."""
    wmt_p, wmt_t = _wmt_corpus()
    cnn_p, cnn_t = _cnndm_corpus()
    sq_p, sq_t = _squad_corpus()
    wmt = [(wmt_p[i : i + WMT_BATCH], wmt_t[i : i + WMT_BATCH]) for i in range(0, WMT_SEGMENTS, WMT_BATCH)]
    out = {name: wmt for name in ("bleu", "sacrebleu", "chrf++", "ter", "eed")}
    out["rouge"] = [(cnn_p[i : i + CNNDM_BATCH], cnn_t[i : i + CNNDM_BATCH]) for i in range(0, CNNDM_PAIRS, CNNDM_BATCH)]
    out["squad"] = [(sq_p[i : i + SQUAD_BATCH], sq_t[i : i + SQUAD_BATCH]) for i in range(0, SQUAD_QUESTIONS, SQUAD_BATCH)]
    return out


def _state_bits(metric) -> dict:
    return {name: [str(getattr(metric, name).dtype), getattr(metric, name).cpu().numpy().tobytes().hex()]
            for name in metric._defaults}


def text_cpu_twin(where: Path) -> int:
    """(a) and (b) through the port on the CPU (``--text-cpu-twin DIR``): each metric's states as
    hex bytes in ``DIR/twin.json``, for the card's to be held against."""
    sys.path.insert(0, str(ROOT))
    import metrics_tpu_torch as mt

    batches = _text_batches()
    metrics = {**_mt_metrics(mt, "cpu"), **_summary_metrics(mt, "cpu")}
    states = {}
    for name, metric in metrics.items():
        for preds, target in batches[name]:
            metric.update(preds, target)
        states[name] = _state_bits(metric)
    (where / "twin.json").write_text(json.dumps(states))
    return 0


def _issues_no_device_operation(where: str, run) -> Optional[int]:
    """Profile ``run()``, then one canary addition on the card: the session must record the canary's
    one device operation and nothing else.  None where no session recorded even the canary."""
    from torch.profiler import ProfilerActivity, profile

    canary = torch.ones(1, device=DEVICE)
    for _ in range(PROFILER_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            canary = canary + 1
            torch.cuda.synchronize()
        seen = [e.name for e in _device_events(prof)]
        if seen:
            if len(seen) != 1:
                raise AssertionError(f"{where}: the updates issued device operations: {seen[:10]}")
            return len(seen)
    print(f"{where}: device operations of the updates not profiled (no session recorded the canary)")
    return None


def _text_audio_update_profile(mt) -> Optional[int]:
    """Phase 16's profile of (a)'s and (b)'s updates on the card, two batches a metric; ``main`` takes it
    early (profiler sessions after the curve phase lose events)."""
    batches = _text_batches()
    metrics = {**_mt_metrics(mt, DEVICE), **_summary_metrics(mt, DEVICE)}

    def run():
        for name, metric in metrics.items():
            for preds, target in batches[name][:2]:
                metric.update(preds, target)

    seen = _issues_no_device_operation("text (phase 16)", run)
    if not all(m._host_buffers_dirty for m in metrics.values()):
        raise AssertionError("text (phase 16): an update wrote a state on the card")
    return seen


def _on_card(name: str, value) -> None:
    tensors = list(value.values()) if isinstance(value, dict) else [value]
    for t in tensors:
        if not isinstance(t, torch.Tensor) or t.device.type != torch.device(DEVICE).type:
            raise AssertionError(f"{name}: a value left the card: {t!r}")
        if not torch.isfinite(t).all():
            raise AssertionError(f"{name}: a value is not finite: {t!r}")


def phase_mt_summaries(mt) -> Tuple[dict, dict]:
    """(a) and (b) on the card: each metric's pass timed alone (updates and ``compute()``), its value
    on the card and finite.  Returns the line and each metric's states for the CPU twin."""
    batches = _text_batches()
    metrics = {**_mt_metrics(mt, DEVICE), **_summary_metrics(mt, DEVICE)}
    line, states = {}, {}
    for name, metric in metrics.items():
        items = sum(len(p) for p, _ in batches[name])
        start = time.perf_counter()
        for preds, target in batches[name]:
            metric.update(preds, target)
        value = metric.compute()
        torch.cuda.synchronize()
        secs = time.perf_counter() - start
        _on_card(name, value)
        states[name] = _state_bits(metric)
        shown = {k: float(v) for k, v in value.items()} if isinstance(value, dict) else float(value)
        line[name] = {"items": items, "seconds": secs, "items_per_s": items / secs, "value": shown}
        print(f"text {name}: {shown} over {items} items at {items / secs!r} items/s")
    return line, states


class _RobertaShaped(torch.nn.Module):
    """An encoder of roberta-large's shape from plain ``torch.nn`` layers, Hugging Face style:
    ``forward(input_ids=, attention_mask=, output_hidden_states=)`` returns ``last_hidden_state`` and,
    when asked, the embeddings' and every layer's output in ``hidden_states``.  Its weights are random
    (normal, 0.02, from a seeded generator on the card; layer norms the identity)."""

    def __init__(self, seed: int) -> None:
        super().__init__()
        s = BERT_SHAPE
        self.word = torch.nn.Embedding(s["vocab"], s["hidden"])
        self.position = torch.nn.Embedding(s["positions"], s["hidden"])
        self.token_type = torch.nn.Embedding(1, s["hidden"])
        self.norm = torch.nn.LayerNorm(s["hidden"], eps=1e-5)
        self.layers = torch.nn.ModuleList(
            torch.nn.TransformerEncoderLayer(s["hidden"], s["heads"], s["ffn"], dropout=0.0, activation="gelu",
                                             layer_norm_eps=1e-5, batch_first=True)
            for _ in range(s["layers"]))
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        with torch.no_grad():
            for name, param in self.named_parameters():
                if "norm" in name:
                    param.fill_(1.0 if name.endswith("weight") else 0.0)
                elif name.endswith("bias"):
                    param.zero_()
                else:
                    param.normal_(0.0, 0.02, generator=gen)

    def forward(self, input_ids, attention_mask, output_hidden_states=False):
        positions = torch.arange(2, 2 + input_ids.shape[1], device=input_ids.device)  # past roberta's padding index
        h = self.norm(self.word(input_ids) + self.position(positions)[None] + self.token_type.weight[0])
        hidden = [h]
        pad = attention_mask == 0
        for layer in self.layers:
            h = layer(h, src_key_padding_mask=pad)
            hidden.append(h)
        return types.SimpleNamespace(last_hidden_state=h, hidden_states=tuple(hidden) if output_hidden_states else None)


def _bert_score(mt, model, tok, device: str, batches: list, **kwargs) -> Tuple[dict, float, dict]:
    metric = mt.BERTScore(model=model, user_tokenizer=tok, max_length=BERT_MAX_LENGTH, batch_size=BERT_BATCH,
                          device=device, **kwargs)
    metric.profile_compute = True
    start = time.perf_counter()
    for preds, target in batches:
        metric.update(preds, target)
    out = metric.compute()
    if device != "cpu":
        torch.cuda.synchronize()
    return out, time.perf_counter() - start, dict(metric.last_compute_breakdown)


def _check_bert(name: str, out: dict, shape: tuple) -> None:
    for key in ("precision", "recall", "f1"):
        values = np.asarray(out[key], np.float64)
        if values.shape != shape or not np.isfinite(values).all() or np.abs(values).max() > 1.0 + 1e-5:
            raise AssertionError(f"{name} {key}: shape {values.shape} (want {shape}) or values out of [-1, 1]")


def phase_bert(mt) -> dict:
    """(c) BERTScore at roberta-large's shape on the card."""
    import copy

    from metrics_tpu_torch.functional.text.bert import _greedy_match
    from metrics_tpu_torch.functional.text.wordpiece import WordPieceTokenizer, build_wordpiece_vocab

    preds, target = _wmt_corpus()
    preds, target = preds[:BERT_PAIRS], target[:BERT_PAIRS]
    start = time.perf_counter()
    tok = WordPieceTokenizer(build_wordpiece_vocab(preds + target, size=BERT_SHAPE["vocab"]))
    with torch.device(DEVICE):
        model = _RobertaShaped(SEED).eval()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start
    batches = [(preds[i : i + WMT_BATCH], target[i : i + WMT_BATCH]) for i in range(0, BERT_PAIRS, WMT_BATCH)]
    out, secs, breakdown = _bert_score(mt, model, tok, DEVICE, batches, num_layers=BERT_NUM_LAYERS)
    _check_bert("bertscore", out, (BERT_PAIRS,))
    side = [(preds[:BERT_SIDE_PAIRS], target[:BERT_SIDE_PAIRS])]
    idf, idf_s, _ = _bert_score(mt, model, tok, DEVICE, side, num_layers=BERT_NUM_LAYERS, idf=True)
    _check_bert("bertscore idf", idf, (BERT_SIDE_PAIRS,))
    layers, layers_s, _ = _bert_score(mt, model, tok, DEVICE, side, all_layers=True)
    _check_bert("bertscore all_layers", layers, (BERT_SHAPE["layers"] + 1, BERT_SIDE_PAIRS))
    # the card against the CPU port on the first pairs, the same weights
    cpu_model = copy.deepcopy(model).to("cpu")
    few = [(preds[:BERT_CPU_PAIRS], target[:BERT_CPU_PAIRS])]
    cpu_out, cpu_s, _ = _bert_score(mt, cpu_model, tok, "cpu", few, num_layers=BERT_NUM_LAYERS)
    card_few, _, _ = _bert_score(mt, model, tok, DEVICE, few, num_layers=BERT_NUM_LAYERS)
    cpu_err = max(float(np.abs(np.asarray(card_few[k]) - np.asarray(cpu_out[k])).max()) for k in ("precision", "recall", "f1"))
    if cpu_err > BERT_CPU_ATOL:
        raise AssertionError(f"bertscore: the card is {cpu_err} from the CPU port on {BERT_CPU_PAIRS} pairs")
    # the matching alone, from identical embeddings
    enc = tok(preds[:BERT_CPU_PAIRS] + target[:BERT_CPU_PAIRS], max_length=BERT_MAX_LENGTH)
    ids = torch.tensor(enc["input_ids"], device=DEVICE)
    mask = torch.tensor(enc["attention_mask"], device=DEVICE)
    with torch.no_grad():
        emb = model(input_ids=ids, attention_mask=mask, output_hidden_states=True).hidden_states[BERT_NUM_LAYERS]
    n = BERT_CPU_PAIRS
    fmask, weights = mask.float(), torch.ones_like(mask, dtype=torch.float32)
    args = (emb[:n], fmask[:n], emb[n:], fmask[n:], weights[:n], weights[n:])
    card_match = _greedy_match(*args)
    cpu_match = _greedy_match(*(a.cpu() for a in args))
    match_err = max(float((card_match[k].cpu() - cpu_match[k]).abs().max()) for k in card_match)
    if match_err > MATCH_ATOL:
        raise AssertionError(f"bertscore: the matching on the card is {match_err} from the CPU's on the same embeddings")
    del cpu_model
    torch.cuda.empty_cache()
    print(f"bertscore: F1 mean {float(np.mean(out['f1']))!r} over {BERT_PAIRS} pairs at {BERT_PAIRS / secs!r} pairs/s "
          f"(roberta-large's shape, layer {BERT_NUM_LAYERS}); breakdown {breakdown}; idf and all_layers runs of "
          f"{BERT_SIDE_PAIRS} pairs in {idf_s:.2f} and {layers_s:.2f} s; the card {cpu_err!r} from the CPU port "
          f"(limit {BERT_CPU_ATOL}), the matching {match_err!r} (limit {MATCH_ATOL})")
    return {"pairs": BERT_PAIRS, "shape": BERT_SHAPE, "num_layers": BERT_NUM_LAYERS, "max_length": BERT_MAX_LENGTH,
            "batch_size": BERT_BATCH, "setup_s": setup_s, "seconds": secs, "pairs_per_s": BERT_PAIRS / secs,
            "f1_mean": float(np.mean(out["f1"])), "last_compute_breakdown": breakdown,
            "idf": {"pairs": BERT_SIDE_PAIRS, "seconds": idf_s, "f1_mean": float(np.mean(idf["f1"]))},
            "all_layers": {"pairs": BERT_SIDE_PAIRS, "seconds": layers_s,
                           "f1_mean_by_layer": np.asarray(layers["f1"]).mean(1).tolist()},
            "cpu": {"pairs": BERT_CPU_PAIRS, "max_abs_err": cpu_err, "atol": BERT_CPU_ATOL, "cpu_seconds": cpu_s},
            "matching": {"max_abs_err": match_err, "atol": MATCH_ATOL}}


def _wsj_signals() -> Tuple[torch.Tensor, torch.Tensor]:
    """WSJ0-2mix-shaped pairs (8 kHz, 4 s): a target of low-passed noise (an 8-sample moving average, so
    most of its power lies below 1 kHz), and an estimate that is the target scaled, smoothed by one more
    tap and with noise at about 10 dB below it.  The noise comes from the seed on the host; the shaping
    runs where the data lives."""
    rng = np.random.default_rng(SEED + 1903)
    white = torch.from_numpy(rng.standard_normal((WSJ_PAIRS, WSJ_SAMPLES + 8), dtype=np.float32)).to(DEVICE)
    noise = torch.from_numpy(rng.standard_normal((WSJ_PAIRS, WSJ_SAMPLES), dtype=np.float32)).to(DEVICE)
    gain = torch.from_numpy(rng.uniform(0.5, 2.0, size=(WSJ_PAIRS, 1)).astype(np.float32)).to(DEVICE)
    run = torch.cumsum(white.double(), dim=1)
    target = ((run[:, 8:] - run[:, :-8]) / np.sqrt(8.0)).float()
    del white, run
    est = target.clone()
    est[:, 1:] = 0.85 * target[:, 1:] + 0.15 * target[:, :-1]
    return (est + 0.3 * noise) * gain, target


def _sdr64(preds: torch.Tensor, target: torch.Tensor) -> np.ndarray:
    """SDR from a float64 solve of the same normal equations (numpy FFTs, a dense solve)."""
    p, t = preds.double().cpu().numpy(), target.double().cpu().numpy()
    t = t / np.linalg.norm(t, axis=-1, keepdims=True)
    p = p / np.linalg.norm(p, axis=-1, keepdims=True)
    n_fft = 1 << (2 * t.shape[-1] - 2).bit_length()
    tf, pf = np.fft.rfft(t, n_fft), np.fft.rfft(p, n_fft)
    r0 = np.fft.irfft(np.abs(tf) ** 2, n_fft)[:, :SDR_FILTER]
    b = np.fft.irfft(np.conj(tf) * pf, n_fft)[:, :SDR_FILTER]
    idx = np.abs(np.arange(SDR_FILTER)[:, None] - np.arange(SDR_FILTER)[None, :])
    sol = np.linalg.solve(r0[:, idx], b[..., None])[..., 0]
    coh = (b * sol).sum(-1)
    return 10 * np.log10(coh / (1 - coh))


def _pit_mixtures(spk: int, est: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``PIT_MIXTURES[spk]`` mixtures of ``spk`` speakers from the pairs, the estimates of each mixture
    in a seeded order; returns (estimates, targets, the order)."""
    n = PIT_MIXTURES[spk]
    rng = np.random.default_rng(SEED + 1904 + spk)
    order = torch.from_numpy(np.stack([rng.permutation(spk) for _ in range(n)])).to(DEVICE)
    tgt = target[: n * spk].reshape(n, spk, -1)
    ests = est[: n * spk].reshape(n, spk, -1)
    return torch.take_along_dim(ests, order[:, :, None], dim=1), tgt, order


def phase_audio(mt) -> dict:
    """(d) SNR, SI-SNR, SI-SDR and SDR over the WSJ0-2mix-shaped pairs, PIT with SI-SDR, the PESQ and STOI gates."""
    import metrics_tpu_torch.functional as F

    start = time.perf_counter()
    est, target = _wsj_signals()
    setup_s = time.perf_counter() - start
    makers = {"snr": lambda d: mt.SignalNoiseRatio(device=d), "si_snr": lambda d: mt.ScaleInvariantSignalNoiseRatio(device=d),
              "si_sdr": lambda d: mt.ScaleInvariantSignalDistortionRatio(device=d),
              "sdr": lambda d: mt.SignalDistortionRatio(filter_length=SDR_FILTER, device=d)}
    line = {"pairs": WSJ_PAIRS, "samples": WSJ_SAMPLES, "batch": WSJ_BATCH, "setup_s": setup_s}
    for name, make in makers.items():
        metric = make(DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, WSJ_PAIRS, WSJ_BATCH):
            metric.update(est[i : i + WSJ_BATCH], target[i : i + WSJ_BATCH])
        value = metric.compute()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        _on_card(name, value)
        if int(metric.total) != WSJ_PAIRS or metric.total.dtype != torch.int32:
            raise AssertionError(f"audio {name}: total {metric.total!r}")
        # the card against the CPU port, batch by batch
        cpu, card = make("cpu"), make(DEVICE)
        for i in range(0, AUDIO_CPU_BATCHES * WSJ_BATCH, WSJ_BATCH):
            cpu.update(est[i : i + WSJ_BATCH].cpu(), target[i : i + WSJ_BATCH].cpu())
            card.update(est[i : i + WSJ_BATCH], target[i : i + WSJ_BATCH])
        atol = SDR_ATOL_DB if name == "sdr" else SNR_ATOL_DB
        err = abs(float(card.compute()) - float(cpu.compute()))
        if err > atol:
            raise AssertionError(f"audio {name}: the card is {err} dB from the CPU port (limit {atol})")
        line[name] = {"value_db": float(value), "seconds": secs, "signals_per_s": WSJ_PAIRS / secs,
                      "cpu_abs_err_db": err, "atol_db": atol}
        print(f"audio {name}: {float(value)!r} dB at {WSJ_PAIRS / secs!r} signals/s; the card {err!r} dB from the CPU")
    per_signal = F.signal_distortion_ratio(est[:WSJ_BATCH], target[:WSJ_BATCH], filter_length=SDR_FILTER)
    err64 = float(np.abs(per_signal.cpu().numpy() - _sdr64(est[:WSJ_BATCH], target[:WSJ_BATCH])).max())
    if err64 > SDR64_ATOL_DB:
        raise AssertionError(f"audio sdr: {err64} dB from a float64 solve (limit {SDR64_ATOL_DB})")
    line["sdr"]["float64_abs_err_db"] = err64
    pit = {}
    for spk in sorted(PIT_MIXTURES):
        mixed, tgt, order = _pit_mixtures(spk, est, target)
        metric = mt.PermutationInvariantTraining(F.scale_invariant_signal_distortion_ratio, "max", device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        perms = []
        for i in range(0, len(mixed), WSJ_BATCH):
            metric.update(mixed[i : i + WSJ_BATCH], tgt[i : i + WSJ_BATCH])
            perms.append(F.permutation_invariant_training(mixed[i : i + WSJ_BATCH], tgt[i : i + WSJ_BATCH],
                                                          F.scale_invariant_signal_distortion_ratio)[1])
        value = metric.compute()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        _on_card(f"pit{spk}", value)
        perm = torch.cat(perms)
        if perm.device.type != torch.device(DEVICE).type:
            raise AssertionError(f"pit {spk}: the permutation left the card")
        # estimate order[b, s] is target s's, so target s's estimate sits where order is s
        want = torch.argsort(order, dim=1).to(torch.int32)
        if not torch.equal(perm, want):
            raise AssertionError(f"pit {spk}: {int((perm != want).any(1).sum())} mixtures not unscrambled")
        k = min(WSJ_BATCH, len(mixed))
        cpu_best = F.permutation_invariant_training(mixed[:k].cpu(), tgt[:k].cpu(), F.scale_invariant_signal_distortion_ratio)[0]
        card_best = F.permutation_invariant_training(mixed[:k], tgt[:k], F.scale_invariant_signal_distortion_ratio)[0]
        err = float((card_best.cpu() - cpu_best).abs().max())
        if err > SNR_ATOL_DB:
            raise AssertionError(f"pit {spk}: the card is {err} dB from the CPU port")
        route = "host LAP" if spk > 6 else "exhaustive on the card"
        pit[str(spk)] = {"mixtures": len(mixed), "value_db": float(value), "seconds": secs,
                         "mixtures_per_s": len(mixed) / secs, "route": route, "cpu_abs_err_db": err}
        print(f"audio pit {spk} speakers ({route}): {float(value)!r} dB, every mixture unscrambled, "
              f"{len(mixed) / secs!r} mixtures/s; the card {err!r} dB from the CPU")
    line["pit"] = pit
    gates = {}
    for name, make in (("pesq", lambda: mt.PerceptualEvaluationSpeechQuality(8000, "nb", device=DEVICE)),
                       ("stoi", lambda: mt.ShortTimeObjectiveIntelligibility(8000, device=DEVICE))):
        try:
            make()
        except ModuleNotFoundError as err:
            gates[name] = str(err)
        else:
            raise AssertionError(f"audio {name}: the gate did not raise (is the optional package installed?)")
    line["gates"] = gates
    print(f"audio: the PESQ and STOI gates raise: {list(gates)}")
    return line


def phase_text_audio(mt, card: str, update_profile: Optional[int] = None) -> dict:
    """Phase 16: (a) the MT metrics over a newstest-shaped corpus, (b) ROUGE and SQuAD, (c) BERTScore at
    roberta-large's shape, (d) SNR, SI-SNR, SI-SDR, SDR, PIT and the PESQ/STOI gates.  A CPU twin of (a) and
    (b) runs in a process of its own meanwhile; the card's states must equal its bitwise.  ``update_profile``
    is :func:`_text_audio_update_profile`'s result where ``main`` took it early, else it is taken here."""
    phase_start = time.perf_counter()
    if update_profile is None:
        update_profile = _text_audio_update_profile(mt)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_text_") as tmp:
        twin_log = open(Path(tmp) / "twin.txt", "w")
        twin = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--text-cpu-twin", tmp], cwd=ROOT,
                                stdout=twin_log, stderr=subprocess.STDOUT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        try:
            text, states = phase_mt_summaries(mt)
            torch.cuda.empty_cache()
            bert = phase_bert(mt)
            torch.cuda.empty_cache()
            audio = phase_audio(mt)
            torch.cuda.empty_cache()
            waited = time.perf_counter()
            code = twin.wait(timeout=SYNC_LIMIT)
            waited = time.perf_counter() - waited
        finally:
            twin.kill()
            twin.wait()
            twin_log.close()
        if code != 0:
            raise AssertionError(f"text: the CPU twin exited {code}:\n{(Path(tmp) / 'twin.txt').read_text()[-4000:]}")
        cpu_states = json.loads((Path(tmp) / "twin.json").read_text())
    for name, bits in states.items():
        if bits != cpu_states[name]:
            diff = [k for k in bits if bits[k] != cpu_states[name].get(k)]
            raise AssertionError(f"text {name}: the card's states {diff} are not the CPU port's bitwise")
    print(f"text: every state of (a) and (b) bitwise the CPU port's (waited {waited:.1f} s for the twin); the "
          f"updates: {'not profiled' if update_profile is None else 'no device operation'}")
    secs = time.perf_counter() - phase_start
    print(f"text_audio phase took {secs:.1f} s")
    return {"text_audio": {"card": card, "text": text, "states_bitwise_cpu": True,
                           "device_ops_in_updates": 0 if update_profile else None, "bert": bert, "audio": audio,
                           "twin_wait_s": waited, "phase_s": secs}}


SERVE_BLOCK_ROWS = 1024  # ServeConfig(block_rows=...): the ingest block
SERVE_BODY_ROWS = 1024  # rows of a top1 / per_class body: 1000 float32 logits and an int64 label a row, 4.1 MB
SERVE_OOB_EVERY = 13  # per_class: an out-of-range stream id on every 13th row, as default_traffic aims them
SERVE_OOB_ID = N_CLASSES + 7  # the id default_traffic aims them at
LATENCY_VALUES, LATENCY_BODY = 1 << 20, 1 << 16  # request latencies: 16 bodies of 65,536 float32
LATENCY_Q = (0.5, 0.99)
MSE_RECORDS, MSE_POSTS = 4_096, 8  # JSON records through POST /ingest
SERVE_QUEUE = 16_384  # ingest queue slots: more than the run's items (each JSON record takes one), so none is refused
DRILL_CHECKPOINT_AT, DRILL_KILL_AT = 25, 40  # bodies into the drill's first server before its checkpoint and its kill
SERVE_STREAMS_QUERY = "0,1,2,3,4,5,6,7,500,999"
SERVE_HTTP_TIMEOUT = 120.0


def _serve_registry(mt, device: str):
    """Phase 17's four jobs on one device: ImageNet top-1, per-class accuracy (1,000 streams), request-latency
    quantiles at phase 11's capacity, and a mean squared error fed JSON records."""
    from metrics_tpu_torch.serve import MetricRegistry

    reg = MetricRegistry()
    reg.register("top1", mt.Accuracy(num_classes=N_CLASSES, device=device))
    reg.register("per_class", mt.MultiStreamMetric(mt.Accuracy(num_classes=N_CLASSES, device=device),
                                                   num_streams=N_CLASSES, device=device))
    reg.register("latency", mt.StreamingQuantile(q=LATENCY_Q, capacity=SKETCH_CAPACITY, max_items=SKETCH_MAX_ITEMS,
                                                 device=device), components=("p50", "p99"))
    reg.register("mse", mt.MeanSquaredError(device=device))
    return reg


def _serve_data() -> dict:
    """Phase 17's traffic on the host, from the seed: phase 4's ImageNet pass (logits, labels, and the per_class
    ids: the labels, with an out-of-range id on every 13th row), log-normal request latencies (ms) and the mse
    job's (pred, target) records."""
    logits, labels, _ = _imagenet_pass()
    x, y = logits.cpu().numpy(), labels.cpu().numpy()
    del logits, labels
    ids = y.astype(np.int32)
    ids[np.arange(N_SAMPLES) % SERVE_OOB_EVERY == SERVE_OOB_EVERY - 1] = SERVE_OOB_ID
    rng = np.random.default_rng(SEED + 17)
    latency = rng.lognormal(mean=np.log(20.0), sigma=0.8, size=LATENCY_VALUES).astype(np.float32)
    mse = rng.uniform(size=(2, MSE_RECORDS)).astype(np.float32)
    return {"x": x, "y": y, "ids": ids, "latency": latency, "mse_p": mse[0], "mse_t": mse[1]}


def _columns_body(job: str, cols: list, ids=None, seq: Optional[int] = None) -> bytes:
    """One ``POST /ingest_columns`` body: a JSON header line, then each column's rows, then the int32 ids."""
    rows = len(cols[0])
    header = {"job": job, "rows": rows, "arity": len(cols), "dtypes": [c.dtype.str for c in cols],
              "shapes": [list(c.shape[1:]) for c in cols], "ids": ids is not None}
    if seq is not None:
        header["seqs"] = [[seq, rows]]
    parts = [json.dumps(header).encode(), b"\n"] + [np.ascontiguousarray(c).tobytes() for c in cols]
    if ids is not None:
        parts.append(np.ascontiguousarray(ids, "<i4").tobytes())
    return b"".join(parts)


def _serve_bodies(data: dict) -> list:
    """Every columnar body of the pass as (job, cols, ids), interleaved top1 / per_class / latency."""
    x, y, ids, lat = data["x"], data["y"], data["ids"], data["latency"]
    per_job = {
        "top1": [("top1", [x[i : i + SERVE_BODY_ROWS], y[i : i + SERVE_BODY_ROWS]], None)
                 for i in range(0, N_SAMPLES, SERVE_BODY_ROWS)],
        "per_class": [("per_class", [x[i : i + SERVE_BODY_ROWS], y[i : i + SERVE_BODY_ROWS]], ids[i : i + SERVE_BODY_ROWS])
                      for i in range(0, N_SAMPLES, SERVE_BODY_ROWS)],
        "latency": [("latency", [lat[i : i + LATENCY_BODY]], None) for i in range(0, LATENCY_VALUES, LATENCY_BODY)],
    }
    out = []
    for k in range(max(len(v) for v in per_job.values())):
        out += [bodies[k] for bodies in per_job.values() if k < len(bodies)]
    return out


def _serve_request(port: int, path: str, body: Optional[bytes] = None) -> Tuple[int, bytes]:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=SERVE_HTTP_TIMEOUT) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def _serve_ok(port: int, path: str, body: Optional[bytes] = None) -> bytes:
    status, reply = _serve_request(port, path, body)
    if status != 200:
        raise AssertionError(f"serve: {path} answered {status}: {reply[:400]!r}")
    return reply


def _in_thread(fn, errors: list) -> threading.Thread:
    """``fn`` on a thread of its own; an exception lands in ``errors`` for the caller to raise."""
    def run():
        try:
            fn()
        except BaseException as err:  # noqa: BLE001 -- handed to the main thread, which raises it
            errors.append(err)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread


def _record_pieces(job) -> list:
    """Record each update the job's metric gets from the batcher: (rows, num_valid or None)."""
    pieces, real = [], job.metric.update

    def update(*args, **kwargs):
        nv = kwargs.get("num_valid")
        pieces.append((int(args[0].shape[0]), None if nv is None else int(nv.reshape(-1)[0])))
        return real(*args, **kwargs)

    job.metric.update = update
    return pieces


SERVE_QUERIES = {
    "full": ["/query?job=top1", "/query?job=per_class", "/query?job=latency", "/query?job=mse"],
    "streams": [f"/query?job=per_class&streams={SERVE_STREAMS_QUERY}"],
    "top_k": ["/query?job=per_class&top_k=5"],
    "where": ["/query?job=per_class&where=gt:0.9&k=8"],
    "metrics": ["/metrics"],
    "healthz": ["/healthz"],
}


def _reader(port: int, stop: threading.Event, latencies: dict) -> None:
    """(b): every endpoint in turn, until ``stop``; each request's ms by endpoint.  It starts once every job has
    folded rows: an ``Accuracy`` has no value before its first update (its input mode is not known yet)."""
    while not all(job["records_ingested"] for job in json.loads(_serve_ok(port, "/healthz"))["jobs"]):
        if stop.is_set():
            return
        time.sleep(0.005)
    while not stop.is_set():
        for kind, paths in SERVE_QUERIES.items():
            for path in paths:
                t0 = time.perf_counter()
                _serve_ok(port, path)
                latencies[kind].append((time.perf_counter() - t0) * 1e3)


def _twin_pieces(mt, ops, kll, data: dict, pieces: dict) -> Tuple[dict, dict, dict]:
    """Twins on the card, each updated directly with the pieces its job's batcher dispatched, in order; their
    launches per entry point, and the launches of one direct update of each (its first piece)."""
    reg = _serve_registry(mt, DEVICE)
    twins = {name: reg[name].metric for name in reg}
    x = torch.from_numpy(data["x"]).to(DEVICE)
    y = torch.from_numpy(data["y"]).to(DEVICE)
    ids = torch.from_numpy(data["ids"]).to(DEVICE)
    lat = torch.from_numpy(data["latency"]).to(DEVICE)
    mse_p, mse_t = torch.from_numpy(data["mse_p"]).to(DEVICE), torch.from_numpy(data["mse_t"]).to(DEVICE)

    def calls(name):
        out, lo = [], 0
        for rows, valid in pieces[name]:
            if name == "top1":
                out.append(((x[lo : lo + rows], y[lo : lo + rows]), {}))
                lo += rows
            elif name == "per_class":
                pad = rows - valid
                block_ids = torch.cat([ids[lo : lo + valid], ids.new_full((pad,), -1)])
                out.append(((torch.cat([x[lo : lo + valid], x.new_zeros((pad, N_CLASSES))]),
                             torch.cat([y[lo : lo + valid], y.new_zeros((pad,))])),
                            {"stream_ids": block_ids, "num_valid": torch.tensor([valid], dtype=torch.int32, device=DEVICE)}))
                lo += valid
            elif name == "latency":
                out.append(((lat[lo : lo + rows],), {}))
                lo += rows
            else:
                out.append(((mse_p[lo : lo + rows], mse_t[lo : lo + rows]), {}))
                lo += rows
        return out

    counters = _ms_counters(ops, kll)
    launches, one = {}, {}
    for name, metric in twins.items():
        feed = calls(name)
        _, one[name] = _launches_of(counters, lambda: metric.update(*feed[0][0], **feed[0][1]))
        _, rest = _launches_of(counters, lambda: [metric.update(*a, **kw) for a, kw in feed[1:]])
        launches[name] = {k: one[name][k] + rest[k] for k in counters}
    return reg, launches, one


def _hand_frame(job: str, seq: int, cols: list, ids=None) -> bytes:
    """A WAL frame built from the documented layout with ``struct`` alone: magic, u32 length, ``<HQIHBBH``
    (version, seq, rows, arity, flags, dtype_len, job_len), the dtype field, the job, the columns, the
    int32 ids, a crc32 of the payload.  Version 1 (one dtype, scalar columns) is the JAX package's frame;
    version 2 lists each column's dtype and per-row dims."""
    import struct
    import zlib

    shaped = any(c.ndim > 1 for c in cols) or len({c.dtype.str for c in cols}) > 1
    dtype = (",".join("x".join([c.dtype.str] + [str(d) for d in c.shape[1:]]) for c in cols) if shaped
             else cols[0].dtype.str).encode()
    job_b = job.encode()
    payload = struct.pack("<HQIHBBH", 2 if shaped else 1, seq, len(cols[0]), len(cols), 0 if ids is None else 1,
                          len(dtype), len(job_b)) + dtype + job_b + b"".join(c.tobytes() for c in cols)
    if ids is not None:
        payload += np.asarray(ids, "<i4").tobytes()
    return b"MTWL" + struct.pack("<I", len(payload)) + payload + struct.pack("<I", zlib.crc32(payload))


def _frame_on_disk(directory: str, seq: int) -> bytes:
    """The bytes of frame ``seq`` as they lie in its segment."""
    from metrics_tpu_torch.serve import wal

    for path in wal.list_segments(directory):
        data = Path(path).read_bytes()
        off = 0
        while off < len(data):
            frame, nxt = wal.decode_frame(data, off)
            if frame.seq == seq:
                return data[off:nxt]
            off = nxt
    raise AssertionError(f"serve drill: no frame {seq} in {directory}")


def _serve_block_profile(mt) -> dict:
    """(device operations, host-to-device and device-to-host copies, device ms) of one block dispatch of each
    columnar job: a full block through ``BlockBatcher.extend_columns``.  Taken early: profiler sessions late in
    the script lose events.  None where the profiler recorded nothing (off the card)."""
    from metrics_tpu_torch.serve import BlockBatcher

    reg = _serve_registry(mt, DEVICE)
    rng = np.random.default_rng(SEED + 170)
    x = rng.standard_normal((SERVE_BLOCK_ROWS, N_CLASSES)).astype(np.float32)
    y = rng.integers(0, N_CLASSES, SERVE_BLOCK_ROWS)
    lat = rng.lognormal(np.log(20.0), 0.8, SERVE_BLOCK_ROWS).astype(np.float32)
    feeds = {"top1": ([x, y], None), "per_class": ([x, y], y.astype(np.int32)), "latency": ([lat], None)}
    out = {}
    for name, (cols, ids) in feeds.items():
        batcher = BlockBatcher(reg[name], block_rows=SERVE_BLOCK_ROWS)
        best = None
        for _ in range(PROFILER_ATTEMPTS):
            seen = _device_ops(lambda: batcher.extend_columns(cols, ids))
            if seen and (best is None or len(seen) > len(best)):
                best = seen
        out[name] = None if best is None else {
            "device_ops": len(best), "htod_copies": sum("HtoD" in op for op, _ in best),
            "dtoh_copies": sum("DtoH" in op for op, _ in best), "device_ms": sum(ms for _, ms in best),
            "ops": sorted({op.split("<")[0].split("(")[0][-40:] for op, _ in best}),
        }
    print(f"serve: one block dispatch, (device operations, host copies): "
          f"{ {k: None if v is None else (v['device_ops'], v['htod_copies'], v['dtoh_copies']) for k, v in out.items()} }")
    return out


def _check_serve_answers(port: int, twins, registry_to_json) -> int:
    """(b) after the flush: every endpoint's answer equals the twin's values widened to float64, bit for bit."""
    checked = 0

    def same(path, key, want):
        nonlocal checked
        got = json.loads(_serve_ok(port, path))[key]
        if json.dumps(got) != json.dumps(want):
            raise AssertionError(f"serve: {path} answered {str(got)[:200]} where the twin gives {str(want)[:200]}")
        checked += 1

    for name in ("top1", "per_class", "latency", "mse"):
        same(f"/query?job={name}", "value", registry_to_json(twins[name].compute()))
    per_class = twins["per_class"]
    streams = [int(s) for s in SERVE_STREAMS_QUERY.split(",")]
    same(f"/query?job=per_class&streams={SERVE_STREAMS_QUERY}", "values",
         registry_to_json(per_class.compute_streams(np.asarray(streams, np.int32))))
    values, ids = per_class.top_k(5)
    same("/query?job=per_class&top_k=5", "top_k", registry_to_json(values))
    same("/query?job=per_class&top_k=5", "stream_ids", [int(i) for i in ids.cpu()])
    hit, total = per_class.where(lambda v: v > 0.9, k=8)
    same("/query?job=per_class&where=gt:0.9&k=8", "stream_ids", [int(i) for i in hit.cpu() if int(i) >= 0])
    same("/query?job=per_class&where=gt:0.9&k=8", "total_matches", int(total))
    return checked


def phase_serve(mt, card: str, block_profile: Optional[dict] = None) -> Tuple[dict, dict]:
    """Phase 17: one ``EvalServer`` on the card with four jobs, fed over localhost HTTP: (a) ingest over the wire,
    each job's state bitwise a twin's updated directly with the same pieces, launches as the pieces imply;
    (b) reads while ingest runs, answers bitwise the twins' after the flush; (c) the durability drill: a WAL,
    a checkpoint, a kill, a restore and a replay with one duplicate frame, bitwise the uninterrupted run;
    (d) the card's checkpoint restored into a registry on the CPU, bitwise.  Returns the serving runs'
    launches per entry point and the phase's line."""
    from metrics_tpu_torch.checkpoint import CheckpointManager
    from metrics_tpu_torch.obs import core as obs_core
    from metrics_tpu_torch.ops import kll
    from metrics_tpu_torch.ops import stat_scores as ops
    from metrics_tpu_torch.serve import EvalServer, ServeConfig, WalWriter, replay_frames
    from metrics_tpu_torch.serve.registry import _to_jsonable

    phase_start = time.perf_counter()
    if block_profile is None:
        block_profile = _serve_block_profile(mt)
    data = _serve_data()
    bodies = _serve_bodies(data)
    wire = {job: [_columns_body(job, cols, ids) for j, cols, ids in bodies if j == job] for job in ("top1", "per_class", "latency")}
    records = [{"values": [float(p), float(t)]} for p, t in zip(data["mse_p"], data["mse_t"])]
    per_post = MSE_RECORDS // MSE_POSTS
    wire["mse"] = [json.dumps({"job": "mse", "records": records[i : i + per_post]}).encode()
                   for i in range(0, MSE_RECORDS, per_post)]
    rows = {"top1": N_SAMPLES, "per_class": N_SAMPLES, "latency": LATENCY_VALUES, "mse": MSE_RECORDS}
    line = {"card": card, "block_rows": SERVE_BLOCK_ROWS, "block_dispatch": block_profile,
            "body_bytes": {job: len(b[0]) for job, b in wire.items()}}
    counters = _ms_counters(ops, kll)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        # (a) + (b): the server, four senders and one reader
        registry = _serve_registry(mt, DEVICE)
        pieces = {name: _record_pieces(registry[name]) for name in registry}
        manager = CheckpointManager(str(Path(tmp) / "ckpt"), rank=0, world_size=1)
        server = EvalServer(registry, ServeConfig(block_rows=SERVE_BLOCK_ROWS, queue_capacity=SERVE_QUEUE), manager).start()
        try:
            errors, firsts = [], {}
            latencies = {kind: [] for kind in SERVE_QUERIES}
            stop = threading.Event()

            def send(job):
                path = "/ingest" if job == "mse" else "/ingest_columns"
                firsts[job] = time.perf_counter()
                for body in wire[job]:
                    reply = json.loads(_serve_ok(server.port, path, body))
                    if reply["rejected"]:
                        raise AssertionError(f"serve: {job}: {reply['rejected']} rows refused")

            for fn in counters.values():
                fn.launches = 0
            torch.cuda.synchronize()
            reader = _in_thread(lambda: _reader(server.port, stop, latencies), errors)
            senders = [_in_thread(lambda job=job: send(job), errors) for job in wire]
            for t in senders:
                t.join()
            if errors:
                raise errors[0]
            if not server.flush(timeout=SERVE_HTTP_TIMEOUT):
                raise AssertionError("serve: the flush did not return within its timeout")
            torch.cuda.synchronize()
            flushed = time.perf_counter()
            launches = {name: fn.launches for name, fn in counters.items()}
            stop.set()
            reader.join()
            if errors:
                raise errors[0]
            health = server.health()
            if health["consumer_errors"]:
                raise AssertionError(f"serve: the consumer recorded errors: {server.consumer.errors[:5]}")
            rates = {job: rows[job] / (flushed - firsts[job]) for job in wire}
            print(f"serve (a): records/s end to end (first POST to the flush's return) {rates!r}; launches {launches}")

            # (a) the pieces, the twins, the launches
            implied = {"top1": [(SERVE_BLOCK_ROWS, None)] * (N_SAMPLES // SERVE_BLOCK_ROWS)
                       + [(c, None) for c in _pow2(N_SAMPLES % SERVE_BLOCK_ROWS)],
                       "per_class": [(SERVE_BLOCK_ROWS, SERVE_BLOCK_ROWS)] * (N_SAMPLES // SERVE_BLOCK_ROWS)
                       + [(SERVE_BLOCK_ROWS, N_SAMPLES % SERVE_BLOCK_ROWS)],
                       "latency": [(SERVE_BLOCK_ROWS, None)] * (LATENCY_VALUES // SERVE_BLOCK_ROWS)}
            for name, want in implied.items():
                if pieces[name] != want:
                    raise AssertionError(f"serve: {name} dispatched {len(pieces[name])} pieces {pieces[name][-6:]}, "
                                         f"not the {len(want)} its bodies imply")
            if sum(r for r, _ in pieces["mse"]) != MSE_RECORDS or any(r & (r - 1) for r, _ in pieces["mse"]):
                raise AssertionError(f"serve: mse pieces {pieces['mse']} are not power-of-two chunks of {MSE_RECORDS}")
            twin_reg, twin_launches, one_update = _twin_pieces(mt, ops, kll, data, pieces)
            twins = {name: twin_reg[name].metric for name in twin_reg}
            serve_states = _states_of(registry.checkpoint_target())
            twin_states = _states_of(twin_reg.checkpoint_target())
            n_states = _same_states("serve (a) against the direct-update twins", serve_states, twin_states)
            total = {k: sum(t[k] for t in twin_launches.values()) for k in counters}
            if launches != total:
                raise AssertionError(f"serve: launches {launches} where the twins' pieces launch {total}")
            for name in ("top1", "per_class", "latency"):
                per_piece = {k: v * len(pieces[name]) for k, v in one_update[name].items()}
                if twin_launches[name] != per_piece or not any(per_piece.values()):
                    raise AssertionError(f"serve: {name}'s {len(pieces[name])} pieces launch {twin_launches[name]}, "
                                         f"not {one_update[name]} each")
            # the integer counts against numpy
            pred = data["x"].argmax(axis=1)
            hit = pred == data["y"]
            top1 = registry["top1"].metric
            # a micro Accuracy counts a right row as a true positive, a wrong one as a false negative
            if int(top1.tp) != int(hit.sum()) or int(top1.tp + top1.fn) != N_SAMPLES:
                raise AssertionError(f"serve: top1 counts {int(top1.tp)} / {int(top1.tp + top1.fn)} against numpy's "
                                     f"{int(hit.sum())} / {N_SAMPLES}")
            ids = data["ids"]
            valid = (ids >= 0) & (ids < N_CLASSES)
            pc = registry["per_class"].metric
            want_rows = np.bincount(ids[valid], minlength=N_CLASSES)
            want_hits = np.bincount(ids[valid & hit], minlength=N_CLASSES)
            if (not np.array_equal(pc.stream_rows.cpu().numpy(), want_rows)
                    or not np.array_equal(pc.tp.cpu().numpy(), want_hits)):
                raise AssertionError("serve: per_class's per-stream counts are not numpy's")
            planted = int((~valid).sum())
            if pc.dropped_rows() != planted:
                raise AssertionError(f"serve: per_class dropped {pc.dropped_rows()} rows, {planted} planted")
            levels = int(registry["latency"].metric.sketch_tree("sketch")["buf"].shape[0])
            print(f"serve (a): {n_states} states bitwise the twins'; pieces top1 {len(pieces['top1'])}, per_class "
                  f"{len(pieces['per_class'])} padded blocks, latency {len(pieces['latency'])}, mse "
                  f"{[r for r, _ in pieces['mse']]}; launches per piece {one_update}; per_class dropped {planted} "
                  f"planted ids, pad rows in neither; kll_fold {levels} + 2 device launches a call")

            # (b) the answers after the flush, and the read latencies
            checked = _check_serve_answers(server.port, twins, _to_jsonable)
            gauges = {line_.split("{", 1)[1].split('"')[1] for line_ in _serve_ok(server.port, "/metrics").decode().splitlines()
                      if line_.startswith("metrics_tpu_metric_value{")}
            if gauges != set(registry):
                raise AssertionError(f"serve: /metrics carries gauges for {sorted(gauges)}, not every job")
            reads = {kind: {"requests": len(v), "p50_ms": float(np.percentile(v, 50)), "p99_ms": float(np.percentile(v, 99))}
                     for kind, v in latencies.items() if v}
            print(f"serve (b): {checked} answers bitwise the twins'; reads while ingest ran: {reads}")

            # (d) the card's checkpoint restored on the CPU
            t0 = time.perf_counter()
            step = server.checkpoint_now()
            checkpoint_ms = (time.perf_counter() - t0) * 1e3
            cpu_reg = _serve_registry(mt, "cpu")
            t0 = time.perf_counter()
            CheckpointManager(str(Path(tmp) / "ckpt"), rank=0, world_size=1).restore(cpu_reg.checkpoint_target(), step=step)
            cpu_restore_ms = (time.perf_counter() - t0) * 1e3
            n_cpu = _same_states("serve (d) the CPU restore of the card's checkpoint", serve_states,
                                 _states_of(cpu_reg.checkpoint_target()))
            print(f"serve (d): checkpoint {checkpoint_ms!r} ms, restored on the CPU in {cpu_restore_ms!r} ms, "
                  f"{n_cpu} states bitwise")
        finally:
            server.kill()
        del twins, twin_reg
        line.update({"records_per_s": rates, "rows": rows, "pieces": {k: len(v) for k, v in pieces.items()},
                     "launches": launches, "launches_per_piece": one_update, "kll_device_launches_per_call": levels + 2,
                     "states_bitwise": n_states, "dropped_rows": planted, "answers_bitwise": checked, "reads": reads,
                     "checkpoint_ms": checkpoint_ms, "cpu_restore_ms": cpu_restore_ms, "cpu_states_bitwise": n_cpu})

        # (c) the durability drill
        wal_dir, drill_ckpt = str(Path(tmp) / "wal"), str(Path(tmp) / "drill_ckpt")
        fsyncs0 = obs_core.counter_value("serve.wal_fsyncs")
        writer = WalWriter(wal_dir)
        config = ServeConfig(block_rows=SERVE_BLOCK_ROWS, wal_exactly_once=True)
        for fn in counters.values():
            fn.launches = 0
        first = EvalServer(_serve_registry(mt, DEVICE), config, CheckpointManager(drill_ckpt, rank=0, world_size=1)).start()
        try:
            seqs = []
            for i, (job, cols, ids_) in enumerate(bodies):
                ticket = writer.append_wait(job, cols, ids_)
                if not ticket.ok:
                    raise AssertionError(f"serve drill: frame {i} did not reach the disk")
                seqs.append(ticket.seq)
                if i < DRILL_KILL_AT:
                    _serve_ok(first.port, "/ingest_columns", _columns_body(job, cols, ids_, seq=ticket.seq))
                if i + 1 == DRILL_CHECKPOINT_AT:
                    first.checkpoint_now()
                    marks = dict(first.last_checkpoint_wal_marks)
                if i + 1 == DRILL_KILL_AT:
                    first.kill()
        finally:
            first.kill()
        writer.close()
        hand = {}
        for i in (0, 1, 2):  # top1 and per_class frames (version 2: logits beside int64 labels), a latency frame (version 1)
            job, cols, ids_ = bodies[i]
            if _frame_on_disk(wal_dir, seqs[i]) != _hand_frame(job, seqs[i], cols, ids_):
                raise AssertionError(f"serve drill: frame {seqs[i]} is not the documented layout")
            hand[job] = len(_hand_frame(job, seqs[i], cols, ids_))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        second = EvalServer(_serve_registry(mt, DEVICE), config, CheckpointManager(drill_ckpt, rank=0, world_size=1)).start()
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        try:
            if second.last_checkpoint_wal_marks != marks:
                raise AssertionError(f"serve drill: restored marks {second.last_checkpoint_wal_marks}, saved {marks}")
            deduped0 = obs_core.counter_value("serve.wal_deduped_frames")
            t0 = time.perf_counter()
            replayed = 0
            frames = list(replay_frames(wal_dir, marks))
            for frame in frames:
                if not second.submit_columns(frame.job, frame.cols, stream_ids=frame.stream_ids,
                                             seqs=[(frame.seq, frame.rows)], timeout=SERVE_HTTP_TIMEOUT):
                    raise AssertionError(f"serve drill: the replay of frame {frame.seq} was refused")
                replayed += frame.rows
            dup = frames[len(frames) // 2]
            second.submit_columns(dup.job, dup.cols, stream_ids=dup.stream_ids, seqs=[(dup.seq, dup.rows)])
            if not second.flush(timeout=SERVE_HTTP_TIMEOUT):
                raise AssertionError("serve drill: the flush after the replay did not return")
            torch.cuda.synchronize()
            replay_s = time.perf_counter() - t0
            deduped = obs_core.counter_value("serve.wal_deduped_frames") - deduped0
            if deduped != 1:
                raise AssertionError(f"serve drill: {deduped} frames deduped, one sent twice")
            drill_launches = {name: fn.launches for name, fn in counters.items()}
            drill_states = _states_of(second.registry.checkpoint_target())
            uninterrupted = {k: v for k, v in serve_states.items() if not k.startswith("col/mse.")}
            n_drill = _same_states("serve (c) the restored and replayed states against the uninterrupted run's",
                                   {k: v for k, v in drill_states.items() if not k.startswith("col/mse.")}, uninterrupted)
        finally:
            second.kill()
        fsyncs = obs_core.counter_value("serve.wal_fsyncs") - fsyncs0
        print(f"serve (c): restore {restore_ms!r} ms, replayed {len(frames)} frames past marks {marks} "
              f"({replayed} rows, {replayed / replay_s!r} rows/s), one duplicate deduped, {fsyncs} fsyncs, "
              f"{n_drill} states bitwise the uninterrupted run's; {len(hand)} frames byte for byte the documented layout")
    secs = time.perf_counter() - phase_start
    line.update({"drill": {"bodies": len(bodies), "checkpoint_after": DRILL_CHECKPOINT_AT, "kill_after": DRILL_KILL_AT,
                           "marks": marks, "restore_ms": restore_ms, "replayed_frames": len(frames),
                           "replayed_rows": replayed, "replay_rows_per_s": replayed / replay_s, "deduped_frames": deduped,
                           "fsyncs": fsyncs, "states_bitwise": n_drill, "hand_built_frame_bytes": hand,
                           "launches": drill_launches},
                 "phase_s": secs})
    print(f"serve phase took {secs:.1f} s")
    served = {k: launches[k] + drill_launches[k] for k in counters}
    return served, {"serve": line}


FLEET_SHARDS, FLEET_RESIZE_TO = 4, 3
FLEET_BLOCK_ROWS = 4096  # ServeConfig(block_rows=...) of every shard, interval flushing off
FLEET_RING = 1 << 21  # rows per (shard, job) staging ring: every stage fits, so no batch is refused
FLEET_BATCH = 16_384  # rows per run_load ingest call
FLEET_PRODUCERS = 4  # per_user's producer threads; latency's one keeps its rows in order (a sketch folds in order)
FLEET_STAGES = (0.6, 0.8, 1.0)  # the share of each pass fed by the end of stage 1 (ingest), 3 (failover), 4 (resize)
TWIN_BATCH = 65_536  # rows per ingest call of the one-shard twins
FLEET_HTTP_TIMEOUT = 120.0  # seconds a flush may take
FLEET_TOP_K, FLEET_WHERE, FLEET_WHERE_K = 10, "gt:4.0", 16
FLEET_STREAMS = "0,1,2,3,4,5,6,7,81270,162540"  # the reader's compute_streams ids
FLEET_QUERIES = {"top_k": f"/query?job=per_user&top_k={FLEET_TOP_K}",
                 "where": f"/query?job=per_user&where={FLEET_WHERE}&k={FLEET_WHERE_K}",
                 "compute_streams": f"/query?job=per_user&streams={FLEET_STREAMS}"}
WORKER_STREAMS, WORKER_BLOCK = 16, 8  # the worker drill's vocabulary, as tests/serve/test_fleet_soak.py runs it
WORKER_ROWS = (600, 900)  # rows fed before the checkpoint, and by the failover
WORKER_LOAD, WORKER_LOAD_BATCH = 400, 50  # process-mode records through the worker fleet's frontend, two children
WORKER_READY_S = 180.0  # the longest a worker may take to print READY
WORKER_DEGRADED_S = 30.0  # the longest the coordinator may take to see a killed worker


def _fleet_data() -> dict:
    """Phase 18's rows on the host: phase 9's MovieLens ratings (halves) with their predictions rounded to eighths,
    phase 12's Zipf user ids, the absolute errors (the latency job's values), and the ImageNet pass's argmax
    predictions and labels, int32.  Every squared error is a multiple of 1/64 and every user's sum stays far below
    2^18, so float32 sums are exact in any order: fleets sharded differently agree bitwise."""
    preds, target, _ = _movielens_pass()
    users = _ml_users()
    logits, labels, _ = _imagenet_pass()
    out = {"p": (torch.round(preds * 8) / 8).cpu().numpy(), "t": target.cpu().numpy(), "users": users.cpu().numpy(),
           "pred": logits.argmax(1).to(torch.int32).cpu().numpy(), "label": labels.to(torch.int32).cpu().numpy()}
    del preds, target, users, logits, labels
    out["err"] = np.abs(out["p"] - out["t"])
    return out


def _fleet_specs(mt, shards: int, root: Optional[str]) -> tuple:
    """The float32 fleet (per_user, latency) and the int32 one (per_class) on DEVICE; a WAL and checkpoints under
    ``root`` (the twins have neither)."""
    from metrics_tpu_torch.serve import FleetSpec, JobSpec, ServeConfig

    common = {"server_config": ServeConfig(block_rows=FLEET_BLOCK_ROWS, flush_interval=3600.0),
              "ring_capacity": FLEET_RING, "device": DEVICE}

    def durable(tag):
        return {} if root is None else {"checkpoint_root": str(Path(root) / tag / "ckpt"), "wal_root": str(Path(root) / tag / "wal")}

    floats = FleetSpec(num_shards=shards, jobs=[
        JobSpec("per_user", lambda: mt.MeanSquaredError(device=DEVICE), num_streams=ML_USERS),
        JobSpec("latency", lambda: mt.StreamingQuantile(q=LATENCY_Q, capacity=SKETCH_CAPACITY, device=DEVICE),
                components=("p50", "p99")),
    ], **durable("floats"), **common)
    ints = FleetSpec(num_shards=shards, jobs=[
        JobSpec("per_class", lambda: mt.Accuracy(num_classes=N_CLASSES, device=DEVICE), num_streams=N_CLASSES),
    ], ingest_dtype=np.int32, **durable("ints"), **common)
    return floats, ints


class _Tally:
    """Kernel launches and dispatched blocks of the calls run through it: the fleets' and the twins' own, apart
    (never both at once: every window ends with a flush, after which no consumer dispatches)."""

    JOBS = ("per_user", "latency", "per_class")

    def __init__(self, counters: dict):
        self.counters = counters
        self.launches = {k: 0 for k in counters}
        self.blocks = {job: 0 for job in self.JOBS}

    def run(self, fn):
        from metrics_tpu_torch.obs import counter_value

        launches = {k: f.launches for k, f in self.counters.items()}
        blocks = {job: counter_value("serve.blocks_dispatched", job=job) for job in self.JOBS}
        try:
            return fn()
        finally:
            for k, f in self.counters.items():
                self.launches[k] += f.launches - launches[k]
            for job in self.JOBS:
                self.blocks[job] += int(counter_value("serve.blocks_dispatched", job=job) - blocks[job])


def _accepted(got: tuple, rows: int, what: str) -> None:
    if tuple(got) != (rows, 0):
        raise AssertionError(f"fleet: {what}: {got} (accepted, rejected) of {rows} rows")


def _feed_twins(twins, data: dict, ml: tuple, im: tuple) -> None:
    """The twins' rows, in the fleets' order, then a flush (at the fleets' flush points)."""
    floats, ints = twins
    for a in range(ml[0], ml[1], TWIN_BATCH):
        b = min(a + TWIN_BATCH, ml[1])
        _accepted(floats.coordinator.ingest_columns("per_user", [data["p"][a:b], data["t"][a:b]], data["users"][a:b]),
                  b - a, "twin per_user")
        _accepted(floats.coordinator.ingest_columns("latency", [data["err"][a:b]]), b - a, "twin latency")
    for a in range(im[0], im[1], TWIN_BATCH):
        b = min(a + TWIN_BATCH, im[1])
        _accepted(ints.coordinator.ingest_columns("per_class", [data["pred"][a:b], data["label"][a:b]],
                                                  data["label"][a:b]), b - a, "twin per_class")
    _fleet_flush(twins, "twins")


def _fleet_flush(fleets, what: str) -> None:
    for fleet in fleets:
        if not fleet.coordinator.flush(timeout=FLEET_HTTP_TIMEOUT):
            raise AssertionError(f"fleet: {what}: the flush did not return within {FLEET_HTTP_TIMEOUT} s")
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _fleet_ingest(fleets, data: dict, ml: tuple, im: tuple, flush: bool = True) -> Optional[dict]:
    """The rows of one stage through ``run_load``: per_user from FLEET_PRODUCERS threads, latency from one (its
    sketch folds rows in arrival order, which the twin replays), per_class from two; then one flush, unless a
    shard is down.  Each job's records/s from its first ingest to the flush's return."""
    from metrics_tpu_torch.serve import run_load

    floats, ints = fleets
    jobs = {
        "per_user": (lambda lo, hi: floats.coordinator.ingest_columns(
            "per_user", [data["p"][ml[0] + lo : ml[0] + hi], data["t"][ml[0] + lo : ml[0] + hi]],
            data["users"][ml[0] + lo : ml[0] + hi]), ml[1] - ml[0], FLEET_PRODUCERS),
        "latency": (lambda lo, hi: floats.coordinator.ingest_columns(
            "latency", [data["err"][ml[0] + lo : ml[0] + hi]]), ml[1] - ml[0], 1),
        "per_class": (lambda lo, hi: ints.coordinator.ingest_columns(
            "per_class", [data["pred"][im[0] + lo : im[0] + hi], data["label"][im[0] + lo : im[0] + hi]],
            data["label"][im[0] + lo : im[0] + hi]), im[1] - im[0], 2),
    }
    starts, reports, errors = {}, {}, []

    def load(name):
        ingest, total, threads = jobs[name]
        starts[name] = time.perf_counter()
        reports[name] = run_load(ingest, total, batch_rows=FLEET_BATCH, threads=threads)

    loaders = [_in_thread(lambda name=name: load(name), errors) for name in jobs]
    for t in loaders:
        t.join()
    if errors:
        raise errors[0]
    for name, report in reports.items():
        if report.errors or report.rejected or report.accepted != jobs[name][1]:
            raise AssertionError(f"fleet: {name}: {report.accepted} accepted, {report.rejected} refused of "
                                 f"{jobs[name][1]}, errors {report.errors[:3]}")
    if not flush:
        return None
    _fleet_flush(fleets, "the fleets")
    done = time.perf_counter()
    return {name: jobs[name][1] / (done - starts[name]) for name in jobs}


def _fleet_reader(port: int, stop: threading.Event, latencies: dict) -> None:
    """(a): per_user's top_k, where and compute_streams through the float fleet's HTTP frontend, in turn, until
    ``stop``; each request's ms by operation."""
    while not stop.is_set():
        for op, path in FLEET_QUERIES.items():
            t0 = time.perf_counter()
            _serve_ok(port, path)
            latencies[op].append((time.perf_counter() - t0) * 1e3)


def _fleet_vs_twins(stage: str, fleets, twins) -> int:
    """Every job's ``compute_all()`` bitwise its one-shard twin's, and the scatter-gather reads equal."""
    from metrics_tpu_torch.serve.soak import trees_bitwise_equal

    checked = 0
    for fleet, twin in zip(fleets, twins):
        got, want = fleet.coordinator.compute_all(), twin.coordinator.compute_all()
        if sorted(got) != sorted(want):
            raise AssertionError(f"fleet ({stage}): jobs {sorted(got)} against the twin's {sorted(want)}")
        for job in want:
            if not trees_bitwise_equal(got[job], want[job]):
                raise AssertionError(f"fleet ({stage}): {job} over {fleet.coordinator.num_shards} shards is not "
                                     "bitwise its one-shard twin's")
            checked += 1
    op, thr = FLEET_WHERE.split(":")
    for fleet, twin, job, k in ((fleets[0], twins[0], "per_user", FLEET_TOP_K), (fleets[1], twins[1], "per_class", 5)):
        for largest in (True, False):
            if fleet.coordinator.top_k(job, k, largest=largest) != twin.coordinator.top_k(job, k, largest=largest):
                raise AssertionError(f"fleet ({stage}): {job} top_k(largest={largest}) differs from the twin's")
        if fleet.coordinator.where(job, op, float(thr), k=FLEET_WHERE_K) != twin.coordinator.where(
                job, op, float(thr), k=FLEET_WHERE_K):
            raise AssertionError(f"fleet ({stage}): {job} where differs from the twin's")
        checked += 3
    return checked


def _fleet_numpy_checks(mt, values: dict, data: dict) -> dict:
    """per_user against numpy's float64 per-user MSE (exact sums: each value its float32 rounding, bit for bit;
    users without ratings NaN), per_class against numpy's per-class hits over rows, latency within the KLL
    rank-error bound of the exact ranks."""
    sq = (data["p"].astype(np.float64) - data["t"].astype(np.float64)) ** 2
    rows = np.bincount(data["users"], minlength=ML_USERS)
    with np.errstate(invalid="ignore", divide="ignore"):
        want = (np.bincount(data["users"], weights=sq, minlength=ML_USERS) / rows).astype(np.float32)
    got = np.asarray(values["per_user"], np.float64).astype(np.float32)
    if not (np.array_equal(np.isnan(got), rows == 0) and np.array_equal(got[rows > 0], want[rows > 0])):
        bad = np.flatnonzero((got != want) & (rows > 0))
        raise AssertionError(f"fleet: per_user differs from numpy's float64 MSE at {bad.size} users, e.g. "
                             f"{[(int(u), float(got[u]), float(want[u])) for u in bad[:3]]}")
    hit = (data["pred"] == data["label"]).astype(np.float64)
    per_rows = np.bincount(data["label"], minlength=N_CLASSES)
    acc = (np.bincount(data["label"], weights=hit, minlength=N_CLASSES) / per_rows).astype(np.float32)
    if not np.array_equal(np.asarray(values["per_class"], np.float64).astype(np.float32), acc):
        raise AssertionError("fleet: per_class differs from numpy's hits over rows")
    from metrics_tpu_torch.streaming import sketches

    ordered = np.sort(data["err"])
    estimates = np.asarray([values["latency"][k] for k in ("p50", "p99")] if isinstance(values["latency"], dict)
                           else values["latency"], np.float64)
    errs = _rank_errors(estimates, LATENCY_Q, ordered)
    eps = sketches.kll_rank_error_bound(ordered.size, SKETCH_CAPACITY)
    if not (errs <= eps).all():
        raise AssertionError(f"fleet: latency quantiles {estimates} have rank errors {errs} past the bound {eps}")
    return {"users_rated": int((rows > 0).sum()), "per_user_bitwise_numpy": int((rows > 0).sum()),
            "latency": estimates.tolist(), "latency_rank_errors": errs.tolist(), "rank_error_bound": eps}


def _fleet_in_process(mt, ops, kll, data: dict, root: str) -> Tuple[dict, dict]:
    """Phase 18 (a): the fleets through ingest with reads, a checkpoint, a kill with failover and WAL replay, and a
    resize, each stage bitwise the one-shard twins; the launches against the dispatched blocks; per_user,
    per_class and latency against numpy.  Returns the fleets' launches and (a)'s part of the line."""
    from metrics_tpu_torch.obs import counter_value
    from metrics_tpu_torch.serve import LocalFleet, make_fleet_http_server

    n_ml, n_im = len(data["p"]), len(data["pred"])
    ml_at = [0] + [int(n_ml * s) for s in FLEET_STAGES]
    im_at = [0] + [int(n_im * s) for s in FLEET_STAGES]
    counters = _ms_counters(ops, kll)
    for fn in counters.values():
        fn.launches = 0
    fleet, twin = _Tally(counters), _Tally(counters)
    fleets, twins, frontend = (), (), None
    try:
        fleets = fleet.run(lambda: tuple(LocalFleet(s).start() for s in _fleet_specs(mt, FLEET_SHARDS, root)))
        twins = twin.run(lambda: tuple(LocalFleet(s).start() for s in _fleet_specs(mt, 1, None)))
        frontend = make_fleet_http_server("127.0.0.1", 0, fleets[0].coordinator)
        threading.Thread(target=lambda: frontend.serve_forever(poll_interval=0.05), daemon=True).start()

        # stage 1: ingest from producer threads while a reader queries the frontend
        latencies = {op: [] for op in FLEET_QUERIES}
        stop, errors = threading.Event(), []
        reader = _in_thread(lambda: _fleet_reader(frontend.server_address[1], stop, latencies), errors)
        rates = fleet.run(lambda: _fleet_ingest(fleets, data, ml_at[0:2], im_at[0:2]))
        stop.set()
        reader.join()
        if errors:
            raise errors[0]
        twin.run(lambda: _feed_twins(twins, data, ml_at[0:2], im_at[0:2]))
        checked = {"ingest": _fleet_vs_twins("ingest", fleets, twins)}
        reads = {op: {"requests": len(v), "p50_ms": float(np.percentile(v, 50)), "p99_ms": float(np.percentile(v, 99))}
                 for op, v in latencies.items() if v}
        if set(reads) != set(FLEET_QUERIES):
            raise AssertionError(f"fleet: the reader got answers for {sorted(reads)} only")
        print(f"fleet (a) ingest: records/s {rates!r}; reads while ingest ran {reads}")

        # stage 2: checkpoint every shard
        t0 = time.perf_counter()
        fleet.run(lambda: [f.checkpoint_all() for f in fleets])
        checkpoint_ms = (time.perf_counter() - t0) * 1e3
        checked["checkpoint"] = _fleet_vs_twins("checkpoint", fleets, twins)

        # stage 3: kill the shard that holds latency, feed rows (the victim's park), fail over with WAL replay
        victim = fleets[0].router.owner("latency")
        for f in fleets:
            f.kill_shard(victim)
            if f.coordinator.health()["dead_shards"] != [victim]:
                raise AssertionError(f"fleet: the health rollup does not name the killed shard {victim}")
        fleet.run(lambda: _fleet_ingest(fleets, data, ml_at[1:3], im_at[1:3], flush=False))
        parked = [f.coordinator.staged_rows() for f in fleets]
        if not all(parked):
            raise AssertionError(f"fleet: no rows parked for the dead shard {victim}: {parked}")
        failover_ms, replayed = [], []
        for f in fleets:
            before = counter_value("serve.wal_replayed_rows", shard=str(victim))
            t0 = time.perf_counter()
            fleet.run(lambda f=f: f.failover(victim))
            failover_ms.append((time.perf_counter() - t0) * 1e3)
            replayed.append(int(counter_value("serve.wal_replayed_rows", shard=str(victim)) - before))
        fleet.run(lambda: _fleet_flush(fleets, "the failover"))
        if not all(r > 0 for r in replayed) or any(f.coordinator.health()["status"] != "serving" for f in fleets):
            raise AssertionError(f"fleet: failover replayed {replayed} rows; health "
                                 f"{[f.coordinator.health()['status'] for f in fleets]}")
        twin.run(lambda: _feed_twins(twins, data, ml_at[1:3], im_at[1:3]))
        checked["failover"] = _fleet_vs_twins("failover", fleets, twins)
        print(f"fleet (a) checkpoint_all {checkpoint_ms!r} ms; failover of shard {victim} {failover_ms!r} ms with "
              f"{replayed} rows replayed from the WAL ({parked} rows parked meanwhile)")

        # stage 4: resize to FLEET_RESIZE_TO shards live, then the rest of the rows
        resize_ms, moved = [], []
        for f in fleets:
            t0 = time.perf_counter()
            summary = fleet.run(lambda f=f: f.resize(FLEET_RESIZE_TO))
            resize_ms.append((time.perf_counter() - t0) * 1e3)
            moved.append(summary["rows_moved"])
            if summary["new_shards"] != FLEET_RESIZE_TO or not summary["drained"]:
                raise AssertionError(f"fleet: resize gave {summary}")
        checked["resize"] = _fleet_vs_twins("resize", fleets, twins)
        rates4 = fleet.run(lambda: _fleet_ingest(fleets, data, ml_at[2:4], im_at[2:4]))
        twin.run(lambda: _feed_twins(twins, data, ml_at[2:4], im_at[2:4]))
        checked["after_resize"] = _fleet_vs_twins("after the resize", fleets, twins)
        values = {**fleets[0].coordinator.compute_all(), **fleets[1].coordinator.compute_all()}
        numpy_checks = _fleet_numpy_checks(mt, values, data)
        print(f"fleet (a) resize {FLEET_SHARDS} -> {FLEET_RESIZE_TO}: {resize_ms!r} ms, {moved} stream rows moved; "
              f"records/s after it {rates4!r}; numpy: {numpy_checks}")
    finally:
        if frontend is not None:
            frontend.shutdown()
            frontend.server_close()
        for f in fleets + twins:
            f.stop()
    for tally, name in ((fleet, "the fleets"), (twin, "the twins")):
        implied = {"stream_canonical": tally.blocks["per_class"], "kll_fold": tally.blocks["latency"]}
        got = {k: tally.launches[k] for k in implied}
        others = {k: v for k, v in tally.launches.items() if k not in implied and v}
        if got != implied or not all(implied.values()) or others:
            raise AssertionError(f"fleet: {name} launched {tally.launches} for dispatched blocks {tally.blocks}")
    print(f"fleet (a): launches {fleet.launches} = the dispatched blocks {fleet.blocks}; twins {twin.launches}; "
          f"{sum(checked.values())} comparisons bitwise the twins'")
    return fleet.launches, {
        "records_per_s": rates, "records_per_s_after_resize": rates4, "reads": reads,
        "checkpoint_all_ms": checkpoint_ms, "victim": victim, "parked_rows": parked, "failover_ms": failover_ms,
        "replayed_rows": replayed, "replay_rows_per_s": [r / (ms / 1e3) for r, ms in zip(replayed, failover_ms)],
        "resize_ms": resize_ms, "resize_rows_moved": moved, "launches": fleet.launches, "blocks": fleet.blocks,
        "twin_launches": twin.launches, "bitwise_vs_twins": checked, "numpy": numpy_checks,
    }


class _Worker:
    """One ``python -m metrics_tpu_torch.serve.worker --device DEVICE`` process (a fresh interpreter: no fork
    after CUDA is initialised) and its ``HTTPShard``; ``ready_ms`` from the start to its ``READY`` line."""

    def __init__(self, shard: int, num_shards: int, checkpoint_root: str):
        argv = [sys.executable, "-m", "metrics_tpu_torch.serve.worker", "--shard", str(shard), "--num-shards",
                str(num_shards), "--num-streams", str(WORKER_STREAMS), "--block-rows", str(WORKER_BLOCK),
                "--checkpoint-root", checkpoint_root, "--wal-exactly-once", "--device", DEVICE]
        self.shard = shard
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.port = self.handle = self.ready_ms = None

    def ready(self) -> "_Worker":
        from metrics_tpu_torch.serve import HTTPShard

        got: list = []
        reader = threading.Thread(target=lambda: got.append(self.proc.stdout.readline()), daemon=True)
        reader.start()
        reader.join(WORKER_READY_S)
        line = got[0].strip() if got else ""
        if not line.startswith("READY "):
            self.kill()
            raise AssertionError(f"fleet (b): worker {self.shard} printed {line!r} within {WORKER_READY_S} s: "
                                 f"{self.proc.stderr.read()[-2000:]}")
        self.ready_ms = (time.perf_counter() - self.t0) * 1e3
        self.port = int(line.split()[1])
        self.handle = HTTPShard("127.0.0.1", self.port)
        return self

    def kill(self) -> None:
        """SIGKILL: no drain, no checkpoint."""
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=30)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.kill()


def _worker_feed(coordinator, lo: int, hi: int) -> None:
    """The drill's rows, single-threaded, as ``tests/serve/test_fleet_soak.py`` feeds them."""
    from metrics_tpu_torch.serve import ColumnTraffic

    tenant = ColumnTraffic("per_tenant", arity=2, num_streams=WORKER_STREAMS, seed=21)
    plain = ColumnTraffic("mse", arity=2, seed=22)
    for start in range(lo, hi, 64):
        end = min(start + 64, hi)
        cols, ids = tenant.batch(start, end)
        _accepted(coordinator.ingest_columns("per_tenant", cols, ids), end - start, "worker drill per_tenant")
        cols, _ = plain.batch(start, end)
        _accepted(coordinator.ingest_columns("mse", cols), end - start, "worker drill mse")


def _fleet_workers(mt, root: str) -> dict:
    """Phase 18 (b): two worker processes on the card behind a coordinator with a WAL: SIGKILL one, feed rows
    (its rows park), fail over to a new process (checkpoint and WAL replay), bitwise a never-killed twin (an
    in-process fleet of the same spec); then process-mode load through the fleet's HTTP frontend."""
    from metrics_tpu_torch.obs import counter_value
    from metrics_tpu_torch.serve import (FleetCoordinator, FleetSpec, LocalFleet, ServeConfig, WalWriter,
                                         make_fleet_http_server, run_process_load)
    from metrics_tpu_torch.serve.fleet import build_router
    from metrics_tpu_torch.serve.soak import trees_bitwise_equal
    from metrics_tpu_torch.serve.worker import drill_jobs

    t_phase = time.perf_counter()
    shards, ckpt = 2, str(Path(root) / "workers" / "ckpt")
    workers = [_Worker(s, shards, ckpt) for s in range(shards)]  # started together: each pays its own start-up
    spec = FleetSpec(num_shards=shards, jobs=drill_jobs(WORKER_STREAMS, device=DEVICE),
                     server_config=ServeConfig(block_rows=WORKER_BLOCK, flush_interval=3600.0), device=DEVICE)
    twin = coordinator = frontend = None
    wal = {s: WalWriter(str(Path(root) / "workers" / "wal" / f"shard_{s:04d}"), segment_bytes=4096) for s in range(shards)}
    replacements = []

    def respawn(shard):
        w = _Worker(shard, coordinator.router.num_shards, ckpt).ready()
        replacements.append(w)
        workers[shard] = w
        return w.handle

    try:
        twin = LocalFleet(spec).start()
        for w in workers:
            w.ready()
        ready_ms = [w.ready_ms for w in workers]
        coordinator = FleetCoordinator(build_router(spec), [w.handle for w in workers], respawn=respawn,
                                       ring_capacity=4096, wal=wal).start()
        frontend = make_fleet_http_server("127.0.0.1", 0, coordinator)
        threading.Thread(target=lambda: frontend.serve_forever(poll_interval=0.05), daemon=True).start()
        for c in (coordinator, twin.coordinator):
            _worker_feed(c, 0, WORKER_ROWS[0])
            if not c.flush(60.0):
                raise AssertionError("fleet (b): the flush did not return")
        steps = {w.shard: w.handle.checkpoint() for w in workers}
        for w in workers:
            if w.handle.last_checkpoint_wal_marks:
                wal[w.shard].truncate_covered(w.handle.last_checkpoint_wal_marks)
        victim = coordinator.router.shard_for("per_tenant", 0)
        workers[victim].kill()
        deadline = time.monotonic() + WORKER_DEGRADED_S
        while coordinator.health()["dead_shards"] != [victim]:
            if time.monotonic() > deadline:
                raise AssertionError(f"fleet (b): the coordinator never saw worker {victim} die")
            time.sleep(0.05)
        for c in (coordinator, twin.coordinator):
            _worker_feed(c, *WORKER_ROWS)
        parked = coordinator.staged_rows()
        if not parked:
            raise AssertionError("fleet (b): no rows parked for the killed worker")
        replayed0 = counter_value("serve.wal_replayed_rows", shard=str(victim))
        t0 = time.perf_counter()
        coordinator.failover(victim)
        failover_ms = (time.perf_counter() - t0) * 1e3
        replayed = int(counter_value("serve.wal_replayed_rows", shard=str(victim)) - replayed0)
        for c in (coordinator, twin.coordinator):
            if not c.flush(60.0):
                raise AssertionError("fleet (b): the flush after the failover did not return")
        if coordinator.health()["status"] != "serving" or replayed <= 0:
            raise AssertionError(f"fleet (b): after the failover {coordinator.health()['status']}, {replayed} replayed")
        if not trees_bitwise_equal(coordinator.compute_all(), twin.coordinator.compute_all()):
            raise AssertionError("fleet (b): the recovered worker fleet is not bitwise the never-killed twin")
        report = run_process_load(f"http://127.0.0.1:{frontend.server_address[1]}", "per_tenant",
                                  total_records=WORKER_LOAD, processes=2, batch_rows=WORKER_LOAD_BATCH,
                                  num_streams=WORKER_STREAMS)
        if report.records != WORKER_LOAD or report.accepted != WORKER_LOAD or report.rejected or report.errors:
            raise AssertionError(f"fleet (b): process load {report}")
        if not coordinator.flush(60.0) or len(coordinator.top_k("per_tenant", 4)[1]) != 4:
            raise AssertionError("fleet (b): the fleet did not settle after the process load")
    finally:
        if frontend is not None:
            frontend.shutdown()
            frontend.server_close()
        if coordinator is not None:
            coordinator.stop()
        for w in workers + replacements:
            w.stop()
        for writer in wal.values():
            writer.close()
        if twin is not None:
            twin.stop()
    line = {"ready_ms": ready_ms, "replacement_ready_ms": replacements[0].ready_ms, "checkpoint_steps": steps,
            "victim": victim, "parked_rows": parked, "failover_ms": failover_ms, "replayed_rows": replayed,
            "bitwise_vs_twin": True, "process_load_records_per_s": report.records_per_s,
            "process_load": {"records": report.records, "accepted": report.accepted, "elapsed_s": report.elapsed_s},
            "secs": time.perf_counter() - t_phase}
    print(f"fleet (b): READY {ready_ms!r} ms, the replacement {replacements[0].ready_ms!r} ms; failover "
          f"{failover_ms!r} ms, {replayed} rows replayed, {parked} parked; bitwise the twin; process load "
          f"{report.records_per_s!r} records/s")
    return line


def _fleet_soak(mt, ops, kll, root: str) -> Tuple[dict, dict]:
    """Phase 18 (c): ``soak.run_drill`` at its defaults on DEVICE, bit-identical; its sketch's launches against
    the blocks dispatched."""
    from metrics_tpu_torch.obs import counter_value
    from metrics_tpu_torch.serve.soak import run_drill

    counters = _ms_counters(ops, kll)
    before = {k: f.launches for k, f in counters.items()}
    blocks0 = counter_value("serve.blocks_dispatched", job="quantiles")
    t0 = time.perf_counter()
    result = run_drill(str(Path(root) / "soak"), device=DEVICE)
    secs = time.perf_counter() - t0
    launches = {k: f.launches - before[k] for k, f in counters.items()}
    blocks = int(counter_value("serve.blocks_dispatched", job="quantiles") - blocks0)
    if not result.identical or result.poller_failures or result.restored_step != result.checkpoint_step:
        raise AssertionError(f"fleet (c): the soak drill: identical {result.identical}, poller failures "
                             f"{result.poller_failures[:3]}, restored {result.restored_step} of {result.checkpoint_step}")
    if result.checkpoint_failures < 1 or result.sync_report.get("fallback") != "local":
        raise AssertionError(f"fleet (c): the drill's faults did not fire: {result.checkpoint_failures}, {result.sync_report}")
    if launches["kll_fold"] != blocks or not blocks or any(v for k, v in launches.items() if k != "kll_fold"):
        raise AssertionError(f"fleet (c): launches {launches} for {blocks} quantile blocks")
    print(f"fleet (c): the soak drill bit-identical in {secs:.1f} s; poller {result.poller_summary}; launches {launches}")
    return launches, {"identical": True, "secs": secs, "checkpoint_step": result.checkpoint_step,
                      "checkpoint_failures": result.checkpoint_failures, "poller": result.poller_summary,
                      "launches": launches, "quantile_blocks": blocks}


def phase_fleet(mt, card: str) -> Tuple[dict, dict]:
    """Phase 18: the serve fleet on the card.  (a) In-process fleets (4 shards, a WAL and checkpoints) through
    ingest with reads, a checkpoint, a kill and failover, and a resize, bitwise their one-shard twins; (b) two
    worker processes behind an ``HTTPShard`` coordinator through a SIGKILL and failover, then process-mode load;
    (c) the soak drill.  Returns the phase's launches per entry point and its line."""
    from metrics_tpu_torch.ops import kll
    from metrics_tpu_torch.ops import stat_scores as ops

    phase_start = time.perf_counter()
    data = _fleet_data()
    setup_s = time.perf_counter() - phase_start
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
        launches, in_process = _fleet_in_process(mt, ops, kll, data, tmp)
        del data
        workers = _fleet_workers(mt, tmp)
        soak_launches, soak = _fleet_soak(mt, ops, kll, tmp)
    total = {k: launches[k] + soak_launches[k] for k in launches}
    secs = time.perf_counter() - phase_start
    print(f"fleet phase took {secs:.1f} s ({setup_s:.1f} s of it making the rows)")
    return total, {"fleet": {"card": card, "in_process": in_process, "workers": workers, "soak": soak,
                             "launches": total, "setup_s": setup_s, "phase_s": secs}}


def _pow2(n: int) -> list:
    """The power-of-two tail ``_pow2_chunks`` cuts ``n`` < block_rows rows into."""
    return [1 << b for b in range(n.bit_length() - 1, -1, -1) if n & (1 << b)]


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
    seen = [(e.name, e.time_range.elapsed_us() / 1e3) for e in _device_events(prof)]
    return seen or None


def _device_events(prof) -> list:
    """The operations on the card (kernels, copies, memsets) of a profiler session, without the
    device-side copies of its user annotations: an enabled obs span records one while a profiler runs."""
    events = prof.events()
    annotations = {e.name for e in events if getattr(e, "is_user_annotation", False)}
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in annotations]


def _in_turns(fns: dict, order: list) -> dict:
    """Each function's device time per call, measured in the given order (A, B, B, A: the card's
    drift falls on both alike); the mean of its turns' medians."""
    turns = {name: [] for name in fns}
    for name in order:
        turns[name].append(_device_ms(fns[name])[0])
    for name, values in turns.items():
        print(f"  {name}: {values!r} ms")
    return {name: statistics.mean(values) for name, values in turns.items()}


def _bound_ms(bytes_moved: int, operations: int, ops_per_s: float) -> Tuple[float, str]:
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = operations / ops_per_s * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _bound(bytes_moved: int, operations: int) -> Tuple[float, str]:
    return _bound_ms(bytes_moved, operations, INT32_OPS_PER_S)


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


# ---------------------------------------------------------------------------------------------------------------
# Phase 19: metric state placed on a device mesh (DTensor leaves, MeshBackend)
# ---------------------------------------------------------------------------------------------------------------
MESH_ACCUM = 8  # updates between syncs, as the JAX package's configuration 10 (bench.py)
MESH_STEPS = 6  # (b): 6 syncs of 8 updates, 48 of the pass's 49 batches
MESH_COCO_IMAGES = 16  # (b): phase 14's COCO val2017-shaped images an update (8 a rank), 768 in all
MESH_NYU_BATCHES = 16  # (b): phase 9's per-pixel errors, the first 16 batches of 8 maps (39.3 M values)
MESH_SYNC_REPS = 10  # (b): timed syncs of configuration 2 through each backend, a turn
MESH_TURNS = ("plain", "placed", "placed", "plain")
# (b): config 2's sync through DistBackend ("plain"), MeshBackend with its reduced states combined ("placed") and
# MeshBackend one collective a state ("separate"), in turns
MESH_SYNC_TURNS = ("plain", "placed", "separate", "separate", "placed", "plain")


def _local(x):
    """A DTensor's local tensor; anything else as it is."""
    return x.to_local() if hasattr(x, "to_local") else x


def _hex(values: dict) -> dict:
    return {k: _local(v).detach().cpu().numpy().tobytes().hex() for k, v in values.items()}


def _check_placed(name: str, metric) -> int:
    """``metric.state`` between syncs as its placement describes it: a reduced state a ``Partial`` DTensor (by its
    reduce) over the metric's own plain tensor; rows, sketch leaves, lists and buffer counts each rank's own."""
    from torch.distributed.tensor import DTensor, Partial

    ops_by_fx = {"sum": "sum", "mean": "avg", "max": "max", "min": "min"}
    sketch = metric._sketch_leaf_key_set()
    placed = 0
    for key, value in metric.state.items():
        fx = metric._reduce_fns[key]
        if fx not in ops_by_fx or key in sketch or isinstance(value, (list, int)):
            if isinstance(value, DTensor):
                raise AssertionError(f"{name}: {key} is a DTensor between syncs")
            continue
        want = (Partial(ops_by_fx[fx]),)
        if not isinstance(value, DTensor) or value.placements != want:
            raise AssertionError(f"{name}: {key} is {type(value).__name__} {getattr(value, 'placements', None)}, not {want}")
        if type(getattr(metric, key)) is not torch.Tensor:
            raise AssertionError(f"{name}: the attribute {key} is not a plain tensor")
        placed += 1
    return placed


def _mesh_one_rank(mt, ops) -> Tuple[dict, dict]:
    """(a): a one-rank mesh on ``cuda:0`` over NCCL.  Configuration 2 over the ImageNet pass placed with
    ``MetricCollection.shard(default_mesh())`` against the unplaced collection, and phase 12 (a)'s per-class
    accuracy placed with ``shard_streams``.  Returns the launches per entry point and the record."""
    import torch.distributed as dist

    from metrics_tpu_torch.multistream import shard_streams, stream_mesh

    where = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    torch.cuda.set_device(0)  # the mesh's one rank on cuda:0, chosen before the mesh is made
    backend = "nccl" if DEVICE == "cuda" else "gloo"  # gloo only where a rehearsal runs the phase on the CPU
    dist.init_process_group(backend, init_method=f"file://{where}/store", rank=0, world_size=1,
                            timeout=timedelta(seconds=SYNC_LIMIT))
    try:
        mesh = mt.default_mesh(device=DEVICE)
        logits, labels, batches = _imagenet_pass()
        n = len(batches)

        def run(col):
            for p, t in batches:
                col.update(p, t)
            return col.compute()

        plain_col, placed_col = _config2(mt), _config2(mt).shard(mesh)
        plain, _, plain_counts = _driven(ops, "config 2 unplaced", lambda: run(plain_col),
                                         lambda: _implied_config2(ops, plain_col, n))
        placed, placed_s, placed_counts = _driven(ops, "config 2 on a one-rank mesh", lambda: run(placed_col),
                                                  lambda: _implied_config2(ops, placed_col, n))
        if placed_counts != plain_counts:
            raise AssertionError(f"mesh (a): the placed pass launched {placed_counts}, the unplaced {plain_counts}")
        if _hex(placed) != _hex(plain):
            raise AssertionError("mesh (a): configuration 2 on the mesh is not bitwise the unplaced collection")
        leaves = sum(_check_placed(f"config 2 {name}", m) for name, m in placed_col.items())
        reports = {name: m.last_sync_report for name, m in placed_col.items()}
        for name, rep in reports.items():
            if rep["backend"] != "MeshBackend" or not rep.get("in_xla_reductions") or rep["bytes_gathered"]:
                raise AssertionError(f"mesh (a): {name}'s sync report {rep}")
        p, t = batches[-1]
        kernel, plain_out = ops.fused_stat_scores_logits(p, t), ops.fused_stat_scores_logits_plain(p, t)
        kernel_err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(kernel, plain_out))
        if kernel_err:
            raise AssertionError(f"mesh (a): stat_scores_logits differs from its plain version by {kernel_err}")

        # ms per update, placed against unplaced, in turns (the placed update checks its inputs for DTensors)
        update_ms = {"plain": [], "placed": []}
        cols = {"plain": plain_col, "placed": placed_col}
        for name in MESH_TURNS:
            col = cols[name]
            col.reset()
            torch.cuda.synchronize()
            start = time.perf_counter()
            for p, t in batches:
                col.update(p, t)
            torch.cuda.synchronize()
            update_ms[name].append((time.perf_counter() - start) * 1e3 / n)
        print(f"mesh (a) ms per config-2 update, in turns {MESH_TURNS}: {update_ms}")

        # phase 12 (a)'s per-class accuracy through shard_streams
        counter = ops.fused_stream_stat_scores_logits
        streams = {}
        for name in ("plain", "placed"):
            m = mt.MultiStreamMetric(mt.Accuracy(num_classes=N_CLASSES, device=DEVICE), num_streams=N_CLASSES,
                                     device=DEVICE)
            if name == "placed":
                shard_streams(m, stream_mesh(device=DEVICE))
            counter.launches = 0
            for p, t in batches:
                m.update(p, t, stream_ids=t)
            launched = counter.launches
            if launched != n:
                raise AssertionError(f"mesh (a): per-class accuracy ({name}) launched the per-stream kernel {launched} times")
            streams[name] = (m, m.compute(), launched)
        if _hex({"v": streams["placed"][1]}) != _hex({"v": streams["plain"][1]}):
            raise AssertionError("mesh (a): shard_streams changed the per-class accuracy")
        stream_leaves = _check_placed("per-class accuracy", streams["placed"][0])
        if streams["placed"][0].sync_backend is not None:
            raise AssertionError("mesh (a): shard_streams installed a backend")
    finally:
        dist.destroy_process_group()
    launches = {"logits": plain_counts["logits"] + placed_counts["logits"],
                "canonical": plain_counts["canonical"] + placed_counts["canonical"],
                "stream_logits": streams["plain"][2] + streams["placed"][2]}
    print(f"mesh (a): configuration 2 on a one-rank NCCL mesh bitwise the unplaced pass, {leaves} DTensor leaves; "
          f"per-class accuracy through shard_streams bitwise ({stream_leaves} leaves); launches {launches}")
    return launches, {
        "config2": {"bitwise": True, "leaves": leaves, "launches": placed_counts, "pass_s": placed_s,
                    "in_xla_reductions": {k: r["in_xla_reductions"] for k, r in reports.items()},
                    "bytes_gathered": sum(r["bytes_gathered"] for r in reports.values()),
                    "update_ms": update_ms, "update_ms_mean": {k: statistics.mean(v) for k, v in update_ms.items()}},
        "shard_streams": {"streams": N_CLASSES, "bitwise": True, "leaves": stream_leaves,
                          "launches": streams["placed"][2]},
        "kernel_vs_plain": {"stat_scores_logits": kernel_err},
    }


def _mesh_scene():
    n_images = MESH_STEPS * MESH_ACCUM * MESH_COCO_IMAGES
    return _coco_scene(SEED + 143, n_images, round(COCO_GTS * n_images / COCO_IMAGES))


def _rank_mesh(mt, ops, rank: int, out: Path) -> None:
    """(b): this rank's half of each batch into ``Accuracy`` + ``MeanAveragePrecision(on_device=True)`` (the JAX
    package's configuration 10) and a ``StreamingQuantile`` of phase 9's errors, each placed on a mesh of the two
    ranks, a sync every 8 updates; then configuration 2 synced through ``MeshBackend`` against ``DistBackend``."""
    from metrics_tpu_torch.detection import device as det_device
    from metrics_tpu_torch.ops import coco_match as cm
    from metrics_tpu_torch.ops import kll

    mesh = mt.default_mesh(device=DEVICE)
    mine = lambda x: torch.chunk(x, SYNC_WORLD)[rank]  # noqa: E731
    _, _, batches = _imagenet_pass()
    scene = _mesh_scene()
    errors = _stream_batches(_absrel_stream())[:MESH_NYU_BATCHES]
    acc = mt.Accuracy(num_classes=N_CLASSES, device=DEVICE).shard(mesh)
    mp = mt.MeanAveragePrecision(device=DEVICE, on_device=True).shard(mesh)
    q = mt.StreamingQuantile(q=SKETCH_Q, capacity=SKETCH_CAPACITY, max_items=SKETCH_MAX_ITEMS, device=DEVICE).shard(mesh)
    half = MESH_COCO_IMAGES // SYNC_WORLD
    counters = {"logits": ops.fused_stat_scores_logits, "kll_fold": kll.kll_fold, "coco_match": cm.coco_match}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    sync_ms = []
    for step in range(MESH_STEPS):
        for i in range(MESH_ACCUM):
            b = step * MESH_ACCUM + i
            acc.update(*(mine(x) for x in batches[b]))
            lo = b * MESH_COCO_IMAGES + rank * half
            mp.update(*_coco_inputs(scene, DEVICE, lo, lo + half))
            if b < MESH_NYU_BATCHES:
                q.update(mine(errors[b]))
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        for m in (acc, mp, q):
            m.sync()
            m.unsync()
        torch.cuda.synchronize()
        sync_ms.append((time.perf_counter() - s0) * 1e3)
    loop_s = time.perf_counter() - start
    loop_launches = {k: fn.launches for k, fn in counters.items()}
    for fn in counters.values():
        fn.launches = 0
    values = {"acc": acc.compute(), "q": q.compute(), **{f"map.{k}": v for k, v in mp.compute().items()}}
    compute_launches = {k: fn.launches for k, fn in counters.items()}
    with q.sync_context():
        leaves = {k: _local(v).cpu().numpy() for k, v in q.sketch_tree("sketch").items()}
    placed = {"acc": _check_placed("acc", acc), "map": _check_placed("map", mp), "q": _check_placed("q", q)}
    # the matcher inside the placed compute against its plain version: the same synced rows, compute again
    kernel_map = _hex({k: v for k, v in values.items() if k.startswith("map.")})
    det_device.coco_match = cm.coco_match_plain
    try:
        mp._computed = None
        plain_map = _hex({f"map.{k}": v for k, v in mp.compute().items()})
    finally:
        det_device.coco_match = cm.coco_match
    p, t = (mine(x) for x in batches[MESH_STEPS * MESH_ACCUM - 1])
    logits_err = max(int((a.long() - b.long()).abs().max())
                     for a, b in zip(ops.fused_stat_scores_logits(p, t), ops.fused_stat_scores_logits_plain(p, t)))

    # configuration 2 synced through the mesh backend (its reduced states combined, and one collective a state)
    # and through DistBackend, on the same states, in turns
    cols = {"placed": _config2(mt).shard(mesh), "separate": _config2(mt).shard(mesh), "plain": _config2(mt)}
    for m in cols["separate"].values():
        m.sync_backend.combine_reductions = False
    for col in cols.values():
        for b in batches[:MESH_ACCUM]:
            col.update(*(mine(x) for x in b))
    sync_turns = {name: [] for name in cols}
    sync_bytes = {}
    for name in MESH_SYNC_TURNS:
        col = cols[name]
        times = []
        for _ in range(MESH_SYNC_REPS):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            for m in col.values():
                m.sync()
                m.unsync()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - s0) * 1e3)
        sync_turns[name].append(statistics.median(times))
        reps = [m.last_sync_report for m in col.values()]
        sync_bytes[name] = {
            "host_bytes": sum(r.get("host_bytes", 0) for r in reps),
            "bytes_gathered": sum(r.get("bytes_gathered", 0) for r in reps),
            "preflight_bytes": sum(r.get("preflight_bytes", 0) for r in reps),
            "backend": reps[0]["backend"],
        }
    synced = {name: _hex(col.compute()) for name, col in cols.items()}
    (out / f"rank{rank}.json").write_text(json.dumps({
        "values": _hex(values), "kernel_map": kernel_map, "plain_map": plain_map, "logits_err": logits_err,
        "loop_launches": loop_launches, "compute_launches": compute_launches, "placed": placed,
        "sync_ms": sync_ms, "loop_s": loop_s, "report": {k: acc.last_sync_report.get(k) for k in
                                                          ("backend", "world_size", "in_xla_reductions", "host_bytes",
                                                           "bytes_gathered")},
        "config2_sync_ms": sync_turns, "config2_bytes": sync_bytes,
        "config2_same": synced["placed"] == synced["plain"] == synced["separate"],
    }))
    np.savez(out / f"rank{rank}.npz", **leaves)


def _mesh_twins(mt) -> dict:
    """What (b)'s synced values must be: one process's Accuracy over every row (bitwise), its mAP over every image
    (within MAP_VALUE_TOL: the ranks' images reach the gathered lists in rank order), and the ``kll_merge`` of the two
    ranks' own sketches in rank order, through the kernel and through its plain version (bitwise)."""
    from metrics_tpu_torch.ops import kll
    from metrics_tpu_torch.streaming import sketches as sk

    _, _, batches = _imagenet_pass()
    acc = mt.Accuracy(num_classes=N_CLASSES, device=DEVICE)
    for b in batches[: MESH_STEPS * MESH_ACCUM]:
        acc.update(*b)
    mp = mt.MeanAveragePrecision(device=DEVICE, on_device=True)
    mp.update(*_coco_inputs(_mesh_scene(), DEVICE))
    errors = _stream_batches(_absrel_stream())[:MESH_NYU_BATCHES]
    trees = []
    for rank in range(SYNC_WORLD):
        q = mt.StreamingQuantile(q=SKETCH_Q, capacity=SKETCH_CAPACITY, max_items=SKETCH_MAX_ITEMS, device=DEVICE)
        for x in errors:
            q.update(torch.chunk(x, SYNC_WORLD)[rank])
        trees.append(q.sketch_tree("sketch"))
    kll.kll_fold.launches = 0
    merged = sk.kll_merge(trees)
    merge_launches = kll.kll_fold.launches
    saved = sk.kll_fold
    sk.kll_fold = kll.kll_fold_plain
    try:
        merged_plain = sk.kll_merge(trees)
    finally:
        sk.kll_fold = saved
    one_q = mt.StreamingQuantile(q=SKETCH_Q, capacity=SKETCH_CAPACITY, max_items=SKETCH_MAX_ITEMS, device=DEVICE)
    one_q.load_state_pytree({"_update_count": 1, **{f"sketch__sk_{k}": v for k, v in merged.items()}})
    return {"acc": _hex({"acc": acc.compute()}), "map": {k: v.cpu().numpy() for k, v in mp.compute().items()},
            "q": _hex({"q": one_q.compute()}), "merged": {k: v.cpu().numpy() for k, v in merged.items()},
            "merged_plain": {k: v.cpu().numpy() for k, v in merged_plain.items()}, "merge_launches": merge_launches}


def _mesh_two_ranks(mt) -> Tuple[dict, dict]:
    """(b): two gloo ranks on ``cuda:0``, checked against the twins.  Returns the ranks' launches and the record."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        where = Path(tmp) / "mesh"
        ranks = _start_ranks("mesh", where)
        want = _mesh_twins(mt)
        records = _wait_ranks("mesh", ranks, where)
        leaves = [dict(np.load(where / f"rank{rank}.npz")) for rank in range(SYNC_WORLD)]
    map_errs = []
    for rank, (record, got) in enumerate(zip(records, leaves)):
        if record["values"]["acc"] != want["acc"]["acc"]:
            raise AssertionError(f"mesh (b): rank {rank}'s accuracy is not one process's")
        if record["values"]["q"] != want["q"]["q"]:
            raise AssertionError(f"mesh (b): rank {rank}'s quantiles are not the rank-order merge's")
        for leaf, value in want["merged"].items():
            plain = want["merged_plain"][leaf]
            if got[leaf].tobytes() != value.tobytes() or plain.tobytes() != value.tobytes():
                raise AssertionError(f"mesh (b): rank {rank}'s merged sketch leaf {leaf} differs (kernel or plain merge)")
        if record["kernel_map"] != record["plain_map"]:
            raise AssertionError(f"mesh (b): rank {rank}'s mAP with coco_match differs from its plain version")
        if record["logits_err"]:
            raise AssertionError(f"mesh (b): rank {rank}'s stat_scores_logits differs from its plain version")
        for key, value in want["map"].items():
            mine = np.frombuffer(bytes.fromhex(record["values"][f"map.{key}"]), value.dtype).reshape(value.shape)
            err = float(np.nanmax(np.abs(mine.astype(np.float64) - value))) if value.size else 0.0
            if not (np.isnan(mine) == np.isnan(value)).all() or err > MAP_VALUE_TOL:
                raise AssertionError(f"mesh (b): rank {rank}'s {key} {mine} against one process's {value}")
            map_errs.append(err)
        if not record["config2_same"]:
            raise AssertionError(f"mesh (b): rank {rank}'s configuration 2 differs between MeshBackend (combined or "
                                 f"not) and DistBackend")
        if record["compute_launches"]["coco_match"] < 1 or record["compute_launches"]["kll_fold"] < 1:
            raise AssertionError(f"mesh (b): rank {rank}'s computes launched {record['compute_launches']}")
        if record["loop_launches"]["logits"] != MESH_STEPS * MESH_ACCUM:
            raise AssertionError(f"mesh (b): rank {rank}'s updates launched {record['loop_launches']}")
    if records[0]["values"] != records[1]["values"]:
        raise AssertionError("mesh (b): the ranks' synced values differ")
    launches = {k: sum(r["loop_launches"][k] + r["compute_launches"][k] for r in records)
                for k in records[0]["loop_launches"]}
    sync_mean = {k: statistics.mean(v) for k, v in records[0]["config2_sync_ms"].items()}
    print(f"mesh (b): two gloo ranks on one card bitwise one process (accuracy, the merged sketch through kernel and plain "
          f"merges), mAP within {MAP_VALUE_TOL} (max {max(map_errs)!r}); config 2 sync ms (rank 0, in turns) "
          f"{records[0]['config2_sync_ms']}, bytes {records[0]['config2_bytes']}; launches {launches}")
    return launches, {
        "ranks": SYNC_WORLD, "updates": MESH_STEPS * MESH_ACCUM, "syncs": MESH_STEPS, "images": MESH_STEPS * MESH_ACCUM * MESH_COCO_IMAGES,
        "sketch_values": MESH_NYU_BATCHES * NYU_BATCH * NYU_H * NYU_W,
        "map_max_abs_err": max(map_errs), "sync_ms": [r["sync_ms"] for r in records], "loop_s": [r["loop_s"] for r in records],
        "report": records[0]["report"], "placed_leaves": records[0]["placed"],
        "config2_sync_ms": [r["config2_sync_ms"] for r in records], "config2_sync_ms_mean": sync_mean,
        "config2_bytes": [r["config2_bytes"] for r in records],
        "launches": launches, "twin_merge_launches": want["merge_launches"],
    }


def phase_mesh(mt, ops, card: str) -> Tuple[dict, dict]:
    """Phase 19: metric state placed on a device mesh.  (a) A one-rank mesh on ``cuda:0`` over NCCL: configuration 2
    and phase 12 (a)'s per-class accuracy; (b) two gloo ranks on the card: the JAX package's configuration 10 and a
    sketch, a sync every 8 updates, and configuration 2 synced through ``MeshBackend`` against ``DistBackend``.
    Returns the phase's launches per entry point and its line."""
    phase_start = time.perf_counter()
    one_launches, one = _mesh_one_rank(mt, ops)
    torch.cuda.empty_cache()
    two_launches, two = _mesh_two_ranks(mt)
    secs = time.perf_counter() - phase_start
    print(f"mesh phase took {secs:.1f} s")
    launches = {"logits": one_launches["logits"] + two_launches["logits"], "canonical": one_launches["canonical"],
                "stream_logits": one_launches["stream_logits"], "kll_fold": two_launches["kll_fold"],
                "coco_match": two_launches["coco_match"]}
    return launches, {"mesh": {"card": card, "one_rank": one, "two_ranks": two, "launches": launches, "phase_s": secs}}


UTILS_STEPS = (10, 100)  # (a): check_forward_full_state_property's num_update_to_compare
UTILS_REPS = 2  # (a): its repetitions of each
UTILS_QUERIES, UTILS_CANDIDATES = 64, 1000  # (b): get_group_indexes over an MS MARCO-shaped id column, shuffled
UTILS_DENOM_ZERO_CLASS = 7  # (b): class_reduce's class with no predictions (and so no true positives)


def _sum_bound(terms: torch.Tensor, divisor: float = 1.0) -> float:
    """How far two float32 sums of ``terms`` in different orders may lie apart: each within
    ``(n - 1) u`` of the exact sum of the absolute values (u = 2**-24), then one division."""
    absolute = float(terms.double().abs().sum())
    return 2 * (terms.numel() - 1) * 2.0**-24 * absolute / divisor + 2 * float(np.spacing(np.float32(absolute / divisor)))


def _utils_forward_check(mt, preds: torch.Tensor, target: torch.Tensor) -> dict:
    """(a): ``check_forward_full_state_property(Accuracy)`` on one ImageNet batch; its printed lines parsed."""
    import contextlib
    import io

    from metrics_tpu_torch.utils import check_forward_full_state_property

    printed = io.StringIO()
    start = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        check_forward_full_state_property(mt.Accuracy, init_args={"num_classes": N_CLASSES, "device": DEVICE},
                                          input_args={"preds": preds, "target": target},
                                          num_update_to_compare=UTILS_STEPS, reps=UTILS_REPS)
    secs = time.perf_counter() - start
    lines = printed.getvalue().strip().splitlines()
    print("\n".join(lines))
    steps = {}
    for line in lines[:-1]:
        label, mean_s, spread_s, n = re.fullmatch(r"full_state_update=(\w+): (\S+)s \+- (\S+) for (\d+) steps", line).groups()
        steps.setdefault(label, {})[int(n)] = {"mean_s": float(mean_s), "std_s": float(spread_s)}
    if len(lines) != 2 * len(UTILS_STEPS) + 1 or "(results match)" not in lines[-1]:
        raise AssertionError(f"check_forward_full_state_property printed {lines}")
    return {"secs": secs, "steps": steps, "recommended": lines[-1]}


def _utils_on_card_vs_cpu(mt, logits: torch.Tensor, labels: torch.Tensor, checks: dict) -> dict:
    """(b): the data helpers on the card's tensors against the same calls on their CPU copies."""
    from metrics_tpu_torch.utils import to_categorical, to_onehot
    from metrics_tpu_torch.utils.data import apply_to_collection, class_reduce, get_group_indexes

    def on_card(name: str, value) -> None:
        devices = []
        apply_to_collection(value, torch.Tensor, lambda t: devices.append(t.device.type))
        if not devices or set(devices) != {torch.device(DEVICE).type}:
            raise AssertionError(f"{name}: results on {set(devices)}, not on the input's device")

    def bitwise(name: str, got, want, record: bool = True) -> None:
        on_card(name, got)
        got = got.cpu()
        same = got.dtype == want.dtype and got.shape == want.shape and (
            torch.equal(got.view(torch.int32), want.view(torch.int32)) if got.dtype == torch.float32
            else torch.equal(got, want))
        if not same:
            raise AssertionError(f"{name}: the card's {got} is not the CPU's {want} bit for bit")
        if record:
            checks[name] = "bitwise"

    timings = {}

    def timed(name: str, fn):
        fn()  # the first call pays the card's lazy module loading
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        timings[name] = (time.perf_counter() - start) * 1e3
        return out

    # to_categorical: the pass's labels back from one-hots, its argmax, and planted ties and NaN, on each axis
    batch = logits[:BATCH].clone()
    batch[0, 3] = batch[0, 11] = float("nan")  # the first NaN wins
    batch[1, 5] = batch[1, 9] = batch[1].max() + 1  # the first of tied maxima wins
    batch[2, :] = 0.0
    batch[2, 4] = -0.0  # -0.0 ties 0.0
    cpu_batch = batch.cpu()
    for dim in (0, 1, -1):
        got = timed(f"to_categorical dim {dim}", lambda: to_categorical(batch, argmax_dim=dim))
        bitwise(f"to_categorical dim {dim}", got, to_categorical(cpu_batch, argmax_dim=dim))
    if to_categorical(batch)[:3].tolist() != [3, 5, 0]:
        raise AssertionError(f"to_categorical's ties and NaN: {to_categorical(batch)[:3].tolist()}")
    onehot = to_onehot(labels[:BATCH], N_CLASSES)
    bitwise("to_categorical of one-hots", to_categorical(onehot), labels[:BATCH].cpu())
    preds = timed("to_categorical of the pass", lambda: to_categorical(logits))
    bitwise("to_categorical of the pass", preds, to_categorical(logits.cpu()))

    # class_reduce over the pass's per-class counts: precision per class, weighted by support
    hit = preds == labels
    num = torch.bincount(labels[hit], minlength=N_CLASSES)
    denom = torch.bincount(preds, minlength=N_CLASSES)
    weights = torch.bincount(labels, minlength=N_CLASSES)
    num[UTILS_DENOM_ZERO_CLASS] = denom[UTILS_DENOM_ZERO_CLASS] = 0
    cpu_counts = num.cpu(), denom.cpu(), weights.cpu()
    fractions = class_reduce(*cpu_counts, "none")
    terms = {"micro": None, "macro": fractions, "weighted": fractions * (weights.cpu().float() / weights.cpu().float().sum())}
    values = {}
    for reduction in ("micro", "macro", "weighted", "none"):
        got = timed(f"class_reduce {reduction}", lambda: class_reduce(num, denom, weights, reduction))
        want = class_reduce(*cpu_counts, reduction)
        if terms.get(reduction) is None:  # "none": one quotient a class; "micro": one quotient of two integer sums
            bitwise(f"class_reduce {reduction}", got, want)
        else:
            on_card(f"class_reduce {reduction}", got)
            bound = _sum_bound(terms[reduction], N_CLASSES if reduction == "macro" else 1.0)
            err = abs(float(got) - float(want))
            if not err <= bound:
                raise AssertionError(f"class_reduce {reduction}: card {float(got)!r}, CPU {float(want)!r}, bound {bound!r}")
            checks[f"class_reduce {reduction}"] = {"card": float(got), "cpu": float(want), "abs_err": err, "bound": bound}
        values[reduction] = float(got) if got.ndim == 0 else None
    if float(class_reduce(num, denom, weights, "none")[UTILS_DENOM_ZERO_CLASS]) != 0.0:
        raise AssertionError("class_reduce: a class with 0 / 0 is not 0")

    # apply_to_collection: to_categorical over nested batches
    nested = {"batches": [logits[:BATCH], logits[BATCH : 2 * BATCH]], "pair": (logits[-BATCH:], "tail"), "n": 3}
    got = timed("apply_to_collection", lambda: apply_to_collection(nested, torch.Tensor, to_categorical))
    want = apply_to_collection(apply_to_collection(nested, torch.Tensor, lambda t: t.cpu()), torch.Tensor, to_categorical)
    for i in range(2):
        bitwise(f"apply_to_collection batches[{i}]", got["batches"][i], want["batches"][i])
    bitwise("apply_to_collection pair[0]", got["pair"][0], want["pair"][0])
    if got["pair"][1] != "tail" or got["n"] != 3 or type(got["pair"]) is not tuple:
        raise AssertionError(f"apply_to_collection changed what it should leave: {got['pair'][1]!r}, {got['n']!r}")

    # get_group_indexes: a re-ranking run's query ids, shuffled
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    ids = torch.arange(UTILS_QUERIES, device=DEVICE).repeat_interleave(UTILS_CANDIDATES) * 7 + 1000
    ids = ids[torch.randperm(ids.numel(), generator=gen, device=DEVICE)]
    groups = timed("get_group_indexes", lambda: get_group_indexes(ids))
    want = get_group_indexes(ids.cpu())
    if len(groups) != len(want) or len(groups) != UTILS_QUERIES:
        raise AssertionError(f"get_group_indexes: {len(groups)} groups on the card, {len(want)} on the CPU")
    for i, (g, w) in enumerate(zip(groups, want)):
        bitwise(f"get_group_indexes group {i}", g, w, record=False)
    checks["get_group_indexes"] = f"{len(groups)} groups bitwise"
    return {"ms": timings, "values": values}


def phase_utils(mt, ops, card: str) -> Tuple[dict, dict]:
    """Phase 20: the public utilities on the card.  (a) ``check_forward_full_state_property(Accuracy)`` on
    phases 4-8's first ImageNet batch; (b) the data helpers on the card's tensors against their CPU copies.
    Returns the phase's launches per entry point and its line."""
    phase_start = time.perf_counter()
    logits, labels, batches = _imagenet_pass()
    preds, target = (x.clone() for x in batches[0])
    counters = _counters(ops)
    forward, launches = _launches_of(counters, lambda: _utils_forward_check(mt, preds, target))
    # the first comparison: the full-state forward updates twice (the accumulated state, then the batch), the other once;
    # then each step of each repetition likewise, and compute() launches nothing
    implied = {"logits": 3 + UTILS_REPS * sum(UTILS_STEPS) * 3, "canonical": 0}
    print(f"phase 20 (a) launches per entry point: {launches} (the forwards imply {implied})")
    if launches != implied:
        raise AssertionError("check_forward_full_state_property did not launch the logits kernel as its forwards imply")
    checks: dict = {}
    helpers, helper_launches = _launches_of(counters, lambda: _utils_on_card_vs_cpu(mt, logits, labels, checks))
    if any(helper_launches.values()):
        raise AssertionError(f"phase 20 (b) launched a stat-scores kernel: {helper_launches}")
    del logits, labels, batches
    secs = time.perf_counter() - phase_start
    print(f"utilities phase took {secs:.1f} s ({card})")
    line = {"utils": {"card": card, "forward_check": forward, "helpers": helpers, "checks": checks,
                      "launches": launches, "phase_s": secs}}
    return launches, line


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
    ms_entries = _ms_entry(ops, logits, labels)
    from metrics_tpu_torch import obs

    obs_profiles = _obs_profiles(mt, obs, logits, labels)
    text_profile = _text_update_profile(mt)  # phase 15 (d)'s, early too
    text_audio_profile = _text_audio_update_profile(mt)  # phase 16 (a)'s and (b)'s, early too
    serve_profile = _serve_block_profile(mt)  # phase 17's block dispatch, early too
    curve_launches, curve_line = phase_curves(mt, ops, logits, labels, card)
    rest_launches, rest_line = phase_rest(mt, ops, logits, labels, card)
    del logits, labels
    torch.cuda.empty_cache()
    regression_launches, regression_line = phase_regression(mt, ops, card)
    torch.cuda.empty_cache()
    wrapper_launches, wrapper_line = phase_wrappers_retrieval(mt, ops, card)
    torch.cuda.empty_cache()
    streaming_launches, kll_entry, streaming_line = phase_streaming(mt, ops, card)
    torch.cuda.empty_cache()
    ms_launches, ms_counts, ms_line = phase_multistream(mt, ops, card)
    torch.cuda.empty_cache()
    core_launches, core_counts, core_line = phase_core_obs(mt, ops, single, obs_profiles, card)
    torch.cuda.empty_cache()
    match_entry, detection_line = phase_detection_image(mt, card)
    torch.cuda.empty_cache()
    generation_line = phase_generation_text(mt, card, text_profile)
    torch.cuda.empty_cache()
    text_audio_line = phase_text_audio(mt, card, text_audio_profile)
    torch.cuda.empty_cache()
    serve_launches, serve_line = phase_serve(mt, card, serve_profile)
    torch.cuda.empty_cache()
    fleet_launches, fleet_line = phase_fleet(mt, card)
    torch.cuda.empty_cache()
    mesh_launches, mesh_line = phase_mesh(mt, ops, card)
    torch.cuda.empty_cache()
    utils_launches, utils_line = phase_utils(mt, ops, card)
    print(f"launches per entry point: main path {launches}, curve phase {curve_launches}, "
          f"rest of classification {rest_launches}, regression {regression_launches}, "
          f"wrappers and retrieval {wrapper_launches}, streaming {streaming_launches}, multistream {ms_launches}, "
          f"core and obs {core_launches} and {core_counts}, serve {serve_launches}, fleet {fleet_launches}, "
          f"mesh {mesh_launches}, utilities {utils_launches}")
    for entry in kernels:
        route = "canonical" if entry["name"] == "stat_scores" else "logits"
        entry["launches"] += (curve_launches[route] + rest_launches[route] + regression_launches[route]
                              + wrapper_launches[route] + streaming_launches[route] + ms_launches[route]
                              + core_launches[route] + serve_launches[route] + fleet_launches[route]
                              + mesh_launches[route] + utils_launches[route])
    kll_entry["launches"] += (ms_counts["kll_fold"] + core_counts["kll_fold"] + serve_launches["kll_fold"]
                              + fleet_launches["kll_fold"] + mesh_launches["kll_fold"])
    kernels.append(kll_entry)
    for entry in ms_entries:
        counter = entry.pop("counter")
        entry["launches"] = (ms_counts[counter] + core_counts[counter] + serve_launches[counter] + fleet_launches[counter]
                             + mesh_launches.get(counter, 0))
        if counter == "stream_canonical":
            entry["large_s"] = core_line["core_obs"]["large_s"]
    kernels.extend(ms_entries)
    match_entry["launches"] += mesh_launches["coco_match"]
    kernels.append(match_entry)
    print(json.dumps(sync_line))
    print(json.dumps(curve_line))
    print(json.dumps(rest_line))
    print(json.dumps(regression_line))
    print(json.dumps(wrapper_line))
    print(json.dumps(streaming_line))
    print(json.dumps(ms_line))
    print(json.dumps(core_line))
    print(json.dumps(detection_line))
    print(json.dumps(generation_line))
    print(json.dumps(text_audio_line))
    print(json.dumps(serve_line))
    print(json.dumps(fleet_line))
    print(json.dumps(mesh_line))
    print(json.dumps(utils_line))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--sync-rank":
        sys.exit(sync_rank(sys.argv[2], int(sys.argv[3]), Path(sys.argv[4])))
    if len(sys.argv) == 3 and sys.argv[1] == "--text-cpu-twin":
        sys.exit(text_cpu_twin(Path(sys.argv[2])))
    sys.exit(main())
