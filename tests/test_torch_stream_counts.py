"""A plain model of the per-stream stat-scores kernel's two routes, on the CPU.

The per-stream entry points (``metrics_tpu_torch/ops/csrc/stat_scores.cu``,
entry point C) run only on the card.  This file holds, in plain PyTorch, the
reformulation their design rests on, block by block as the kernel lays out
its work, and checks it bitwise against the port's plain versions
(``fused_stream_stat_scores{,_logits}_plain``) and against the JAX package's
per-row ``_stat_scores_update`` under ``jax.vmap`` with ``jax.ops.segment_sum``
(what ``metrics_tpu/multistream/core.py`` computes for a StatScores base):

* the logits route: phase 1 writes each row's (stream, argmax, label); phase
  2 gives each block ranges of the flat ``s * W + class`` outputs and turns
  per-range histograms of tp, pc (rows that predict the class), lc (rows
  labelled with it) and each stream's rows into the four counts, micro or not;
* the canonical route: column tiles, a cluster of ranks along the rows,
  groups of streams past the shared memory a block holds (the large-S
  branch), per-block counts pushed to the owner of each stream, and the
  owner's stores; with micro, a block's tile is the whole row.

Each model also checks that every output is stored exactly once, by its
owner, with the kernel's launch geometry (mirrored from the launchers in the
source, at the H100's 132 SMs).  The model is used by these tests only.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.functional.classification.stat_scores import _stat_scores_update
from metrics_tpu.utils.enums import DataType
from metrics_tpu_torch.ops import stat_scores as ops
from metrics_tpu_torch.utils.data import _total_order_keys

THREADS, WARPS, ROWS_PER_LANE, MAX_CLUSTER, CLASS_CHUNK = 256, 8, 8, 8, 2048
STREAM_SMEM, GROUP_IDS = 96 * 1024, 4
SMS = 132
UNSTORED = -(2**31)


def _written_once(writes: torch.Tensor) -> None:
    assert int(writes.min()) == 1 and int(writes.max()) == 1, "an output was stored twice or not at all"


def _planes(out: torch.Tensor, s: int, w: int, micro: bool):
    return tuple(x.reshape(s) if micro else x for x in out.view(4, s, w).unbind(0))


# ------------------------------------------------------------------ the logits route
def logits_blocks(n: int, c: int, s: int, micro: bool, sms: int = SMS) -> int:
    """The launcher's grid: a warp per row in phase 1, at most 2048 outputs a block at a time in phase 2, two
    blocks an SM at most."""
    outputs = s * (1 if micro else c)
    return max(min(max(-(-n // WARPS), -(-outputs // CLASS_CHUNK)), 2 * sms), 1)


def logits_route(logits, labels, ids, s: int, micro: bool, blocks: int):
    n, c = logits.shape
    w = 1 if micro else c
    outputs = s * w
    # phase 1: each row's triple; the argmax ranks by IEEE totalOrder and takes the lowest index of a tie
    keys = _total_order_keys(logits.float()) if n else torch.zeros((0, c), dtype=torch.int32)
    pred = keys.argmax(1) if n else torch.zeros(0, dtype=torch.int64)
    ids, labels = ids.long(), labels.long()
    row_id = torch.where((ids >= 0) & (ids < s), ids, torch.full_like(ids, -1))
    row_label = torch.where((labels >= 0) & (labels < c), labels, torch.full_like(labels, -1))
    live = row_id >= 0
    out = torch.full((4 * outputs,), UNSTORED, dtype=torch.int32)
    writes = torch.zeros(outputs, dtype=torch.int32)
    # phase 2: each block's ranges of the flat outputs, histogrammed from every row's triple
    span = min(-(-outputs // blocks), CLASS_CHUNK)  # `blocks`: the blocks that scan in phase 2
    for block in range(blocks):
        for o0 in range(block * span, outputs, blocks * span):
            length = min(span, outputs - o0)
            s0, s1 = o0 // w, (o0 + length - 1) // w
            assert s1 - s0 + 1 <= span  # the rows histogram fits beside the other three
            tp, pc, lc, rows = (torch.zeros(span, dtype=torch.int32) for _ in range(4))
            at = row_id * w - o0
            at_p = at + (0 if micro else pred)
            hit_p = live & (at_p >= 0) & (at_p < length)
            pc.index_add_(0, at_p[hit_p], torch.ones(int(hit_p.sum()), dtype=torch.int32))
            hit_tp = hit_p & (pred == row_label)
            tp.index_add_(0, at_p[hit_tp], torch.ones(int(hit_tp.sum()), dtype=torch.int32))
            at_l = at + (0 if micro else row_label)
            hit_l = live & (row_label >= 0) & (at_l >= 0) & (at_l < length)
            lc.index_add_(0, at_l[hit_l], torch.ones(int(hit_l.sum()), dtype=torch.int32))
            hit_s = live & (row_id >= s0) & (row_id <= s1)
            rows.index_add_(0, row_id[hit_s] - s0, torch.ones(int(hit_s.sum()), dtype=torch.int32))
            o = torch.arange(o0, o0 + length)
            t, p, l = tp[:length], pc[:length], lc[:length]
            total = rows[o // w - s0].long() * (c if micro else 1)
            out[o], out[outputs + o] = t, p - t
            out[2 * outputs + o] = (total - p - l + t).to(torch.int32)
            out[3 * outputs + o] = l - t
            writes[o] += 1
    _written_once(writes) if outputs else None
    return _planes(out, s, w, micro)


# ------------------------------------------------------------------ the canonical route
def count_shape(itemsize: int, vb: int, seg: int):
    """StreamShape: (elements a load, threads side by side along a row, rows a block reads at once, classes a tile)."""
    elems = vb // itemsize
    seg = seg if vb >= 8 else 32
    return elems, seg, THREADS // seg, seg * elems


def vector_bytes(row_bytes: int) -> int:
    """The widest load the rows allow (the tensors' own addresses are 16-byte aligned)."""
    m = row_bytes | 16
    return m & -m


def canonical_geometry(n: int, c: int, s: int, micro: bool, itemsize: int, smem: int = STREAM_SMEM, sms: int = SMS) -> dict:
    """``launch_stream_counts``: tiles (two threads wide, four once the streams split into groups), groups of
    streams, cluster ranks and the streams a block holds; a tile's rows are padded by 4 classes."""
    vb = vector_bytes(c * itemsize)
    elems, seg, lanes, cols = count_shape(itemsize, vb, 2)
    per_stream, at_once, tiles, groups = 16, THREADS, 1, 1
    if not micro:
        per_stream, tiles, at_once = 4 * (3 * (cols + 4) + 1), -(-c // cols), lanes * ROWS_PER_LANE
        if s * per_stream > smem:
            elems, seg, lanes, cols = count_shape(itemsize, vb, 4)
            per_stream, tiles, at_once = 4 * (3 * (cols + 4) + 1), -(-c // cols), GROUP_IDS * THREADS
            groups = -(-s // (smem // per_stream))
    ranks = 1
    while ranks < MAX_CLUSTER and ranks * at_once < n:
        ranks *= 2
    if micro:
        groups = max(min(2 * sms // ranks, s), -(-s // (smem // per_stream)))
    return {"vb": vb, "lanes": lanes, "cols": 1 if micro else cols, "tiles": tiles, "groups": groups, "ranks": ranks,
            "listed": THREADS if micro else GROUP_IDS * THREADS,
            "sl": -(-s // groups), "smem_bytes": -(-s // groups) * per_stream}


def canonical_route(preds, target, ids, s: int, micro: bool, smem: int = STREAM_SMEM, sms: int = SMS):
    n, c = preds.shape
    g = canonical_geometry(n, c, s, micro, preds.element_size(), smem, sms)
    cols, groups, ranks, sl, lanes, listed = g["cols"], g["groups"], g["ranks"], g["sl"], g["lanes"], g["listed"]
    assert ranks & (ranks - 1) == 0 and g["smem_bytes"] <= smem
    w = 1 if micro else c
    plane = s * w
    pos, same = preds == 1, target == preds
    kinds = [same & pos, ~same & pos, ~same & ~pos]  # tp, fp, fn; tn is the rest
    ids = ids.long()
    valid = (ids >= 0) & (ids < s)
    grouped = micro or groups > 1
    r = torch.arange(n)
    # the rank that reads a row: passes of `listed` rows, or (ungrouped) each lane's rows `lanes` apart
    rank_of = (r // listed) % ranks if grouped else (r // lanes) % ranks
    out = torch.full((4 * plane,), UNSTORED, dtype=torch.int32)
    writes = torch.zeros(plane, dtype=torch.int32)
    for tile in range(g["tiles"]):
        c0, c1 = (0, c) if micro else (tile * cols, min(tile * cols + cols, c))
        for group in range(groups):
            mine = valid & (ids % groups == group)
            q_of = ids // groups
            shared = []
            for rank in range(ranks):
                cnt = torch.zeros((4, sl, cols), dtype=torch.int32)  # tp, fp, fn and (in [3, :, 0]) rows
                take = mine & (rank_of == rank)
                q = q_of[take]
                for kind, hit in enumerate(kinds):
                    part = hit[take][:, c0:c1].to(torch.int32)
                    if micro:
                        cnt[kind, :, 0].index_add_(0, q, part.sum(1, dtype=torch.int32))
                    else:
                        cnt[kind, :, : c1 - c0].index_add_(0, q, part)
                cnt[3, :, 0].index_add_(0, q, torch.ones(q.shape[0], dtype=torch.int32))
                shared.append(cnt)
            # every block adds the streams it does not own into their owner's counts
            owner = torch.arange(sl) & (ranks - 1)
            for rank in range(ranks):
                for other in range(ranks):
                    if other != rank:
                        shared[rank][:, owner == rank] += shared[other][:, owner == rank]
            for rank in range(ranks):
                for q in range(rank, sl, ranks):
                    stream = group + q * groups
                    if stream >= s:
                        continue
                    t, f, m = (shared[rank][k, q, : c1 - c0].long() for k in range(3))
                    total = int(shared[rank][3, q, 0]) * (c if micro else 1)
                    at = stream * w + (torch.zeros(1, dtype=torch.int64) if micro else torch.arange(c0, c1))
                    out[at], out[plane + at], out[3 * plane + at] = t.int(), f.int(), m.int()
                    out[2 * plane + at] = (total - t - f - m).int()
                    writes[at] += 1
    _written_once(writes)
    return _planes(out, s, w, micro)


# ------------------------------------------------------------------ the JAX package's per-row update
@functools.lru_cache(maxsize=None)
def _jax_stream_counts(c: int, s: int, micro: bool, logits: bool):
    """``jax.vmap`` of the per-row ``_stat_scores_update``, then ``segment_sum`` into the streams (rows with an id
    outside ``[0, s)`` scatter to segment ``s``, which is dropped), jitted once per shape."""
    mode = DataType.MULTICLASS if logits else DataType.MULTILABEL
    extra = {"top_k": 1} if logits else {}

    def one_row(p, t):
        return _stat_scores_update(p[None], t[None], reduce="micro" if micro else "macro", num_classes=c, mode=mode,
                                   validate_args=False, **extra)

    def counts(p, t, ids):
        safe = jnp.where((ids >= 0) & (ids < s), ids, s)
        return tuple(jax.ops.segment_sum(x.reshape(x.shape[0]) if micro else x, safe, num_segments=s)
                     for x in jax.vmap(one_row)(p, t))

    return jax.jit(counts)


def _jax(a, b, ids, s, micro, logits):
    if logits:
        a = a.float()  # the per-row update ranks float32 logits; the bf16 and f16 cases convert exactly
    else:
        a, b = a.to(torch.int32), b.to(torch.int32)
    out = _jax_stream_counts(a.shape[1], s, micro, logits)(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                                                           jnp.asarray(ids.numpy()))
    return tuple(np.asarray(x) for x in out)


def _same(got, want):
    for g, x in zip(got, want):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        assert g.dtype == torch.int32 and tuple(g.shape) == x.shape, (g.shape, x.shape)
        np.testing.assert_array_equal(g.numpy(), x.astype(np.int64))


# ------------------------------------------------------------------ inputs
def _logits(n, c, dtype, seed):
    """Logits on a grid of quarters (ties in most rows), rows of NaN, -NaN, signed zeros and infinities."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-8, 9, (n, c)) / 4).astype(np.float32)
    if n >= 6 and c >= 3:
        x[0] = -np.inf
        x[1, 1::2] = np.nan
        x[2] = 0.0
        x[2, 0] = -0.0
        x[3, 1] = np.copysign(np.nan, -1.0)
        x[4, 1:3] = np.inf
        x[5] = 0.25  # all tied
    return torch.from_numpy(x).to(dtype)


def _ids(n, s, dtype, seed, lo=-2, hi=None):
    rng = np.random.default_rng(seed + 1)
    return torch.from_numpy(rng.integers(lo, s + 2 if hi is None else hi, n)).to(dtype)


def _labels(n, c, dtype, seed):
    rng = np.random.default_rng(seed + 2)
    return torch.from_numpy(rng.integers(-1, c + 2, n)).to(dtype)  # out of range on both sides


# (n, c, s): S = 1, C = 1, C not a multiple of 4, N = 0, more outputs than one block's shared memory
LOGIT_CASES = [(96, 7, 5), (200, 1, 3), (64, 9, 1), (0, 5, 3), (300, 600, 6), (33, 4, 40)]


@pytest.mark.parametrize("micro", [False, True], ids=["per_class", "micro"])
@pytest.mark.parametrize("n,c,s", LOGIT_CASES)
def test_logits_route_model_matches_plain_and_jax(n, c, s, micro):
    for k, (dtype, label_dtype, id_dtype) in enumerate([(torch.float32, torch.int64, torch.int64),
                                                        (torch.bfloat16, torch.int32, torch.int32),
                                                        (torch.float16, torch.int64, torch.int32)]):
        logits, labels, ids = _logits(n, c, dtype, n + c + k), _labels(n, c, label_dtype, n + k), _ids(n, s, id_dtype, k)
        plain = ops.fused_stream_stat_scores_logits_plain(logits, labels, ids, s, micro)
        for blocks in sorted({logits_blocks(n, c, s, micro), 1, 3}):  # the launcher's grid; ranges that loop
            _same(logits_route(logits, labels, ids, s, micro, blocks), plain)
        if dtype == torch.float32:
            _same(plain, _jax(logits, labels, ids, s, micro, logits=True))


@pytest.mark.parametrize("micro", [False, True], ids=["per_class", "micro"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.bool])
@pytest.mark.parametrize("n,c,s,smem", [
    (96, 7, 5, STREAM_SMEM),      # C not a multiple of 4: scalar loads, one tile
    (1500, 40, 6, STREAM_SMEM),   # a cluster of ranks along the rows, several tiles
    (1500, 40, 37, 2048),         # a small shared memory: groups of streams (the large-S branch) and ranks
    (700, 40, 37, 2048),          # groups without a cluster
    (70, 1, 3, STREAM_SMEM),      # C = 1
    (50, 16, 1, STREAM_SMEM),     # S = 1
    (0, 9, 4, STREAM_SMEM),       # N = 0
])
def test_canonical_route_model_matches_plain_and_jax(n, c, s, smem, dtype, micro):
    rng = np.random.default_rng(n + c + s)
    preds = torch.from_numpy(rng.integers(0, 2, (n, c))).to(dtype)
    target = torch.from_numpy(rng.integers(0, 2, (n, c))).to(dtype)
    for id_dtype in (torch.int64, torch.int32):
        ids = _ids(n, s, id_dtype, s)
        plain = ops.fused_stream_stat_scores_plain(preds, target, ids, s, micro)
        _same(canonical_route(preds, target, ids, s, micro, smem=smem), plain)
        if id_dtype == torch.int64:
            _same(plain, _jax(preds, target, ids, s, micro, logits=False))


@pytest.mark.parametrize("micro", [False, True], ids=["per_class", "micro"])
def test_canonical_route_model_counts_values_outside_zero_one(micro):
    """The kernel's predicates hold for any int32 values: pos = (p == 1), same = (t == p)."""
    rng = np.random.default_rng(9)
    preds = torch.from_numpy(rng.integers(-2, 3, (700, 33)).astype(np.int32))
    target = torch.from_numpy(rng.integers(-2, 3, (700, 33)).astype(np.int32))
    ids = _ids(700, 300, torch.int64, 4, lo=-5, hi=310)
    plain = ops.fused_stream_stat_scores_plain(preds, target, ids, 300, micro)
    for smem in (STREAM_SMEM, 4096):
        _same(canonical_route(preds, target, ids, 300, micro, smem=smem), plain)


def test_the_geometry_of_the_main_path_and_the_large_s_threshold():
    """The launch geometry the source's note states, at the main path's shapes."""
    f1 = canonical_geometry(1024, 1000, 64, False, 4)  # the timing shape: int32, 16-byte loads
    assert (f1["cols"], f1["tiles"], f1["ranks"], f1["groups"], f1["smem_bytes"]) == (8, 125, 1, 1, 64 * 148)
    top5 = canonical_geometry(1024, 1000, 1000, True, 4)  # per-class top-5, micro, int32 masks
    assert (top5["ranks"], top5["groups"]) == (4, 66)
    assert canonical_geometry(1024, 1000, 664, False, 4)["groups"] == 1  # int32 at 16-byte loads
    large = canonical_geometry(1024, 1000, 665, False, 4)  # the large-S branch: 16-class tiles, no cluster
    assert (large["cols"], large["groups"], large["ranks"]) == (16, 2, 1)
    assert canonical_geometry(4096, 1000, 1000, False, 4)["ranks"] == 4
    assert canonical_geometry(1024, 1024, 225, False, 1)["groups"] == 1  # bool at 16-byte loads: 32-class tiles
    assert canonical_geometry(1024, 1024, 226, False, 1)["groups"] == 2
    assert logits_blocks(1024, 1000, 64, False) == 128 and logits_blocks(1024, 1000, 1000, True) == 128


def test_the_micro_sums_are_the_per_class_identities_summed():
    """With micro the logits route stores fp = rows - tp and tn = C * rows - pc - lc + tp with pc = rows."""
    logits, labels = _logits(400, 11, torch.float32, 3), _labels(400, 11, torch.int64, 3)
    ids = _ids(400, 9, torch.int64, 3)
    per_class = logits_route(logits, labels, ids, 9, False, 4)
    micro = logits_route(logits, labels, ids, 9, True, 4)
    rows = torch.bincount(ids[(ids >= 0) & (ids < 9)], minlength=9).to(torch.int32)
    for x, m in zip(per_class, micro):
        assert torch.equal(x.sum(1, dtype=torch.int32), m)
    tp, fp, tn, fn = micro
    assert torch.equal(fp, rows - tp) and torch.equal(tn + fp + fn + tp, 11 * rows)
