"""The host kernels in C++ (``native.cpp`` and ``text.cpp``, bound with ``ctypes``), each with its
pure-Python fallback.

Counterpart of ``metrics_tpu/_native``, whose C++ source ``native.cpp`` is a
verbatim copy.  They cover the host-sequential algorithms of the metrics: the
edit distance of the text metrics, the COCO RLE mask codec, the greedy COCO
matcher and the precision tables of ``MeanAveragePrecision``'s host route,
and the linear assignment of the audio metrics' permutation search.
``text.cpp`` adds the port's own: the extended edit distance's grid, which the
JAX package runs in Python.

The library is compiled with ``g++ -O3 -ffp-contract=off`` at first use into
``build/native/`` at the root of the checkout, named by a hash of the
sources: an edited source builds anew, an unchanged one loads what is there.  Where it cannot be built
(no compiler) every function takes its pure-Python fallback, which computes
the same values; those that return ``None`` instead tell their caller to run
its own fallback.  :func:`native_available` says which it is.  Every function
takes and returns numpy arrays on the host.
"""

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native.cpp"
TEXT_SOURCE = SOURCE.with_name("text.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_P_I64 = ctypes.POINTER(ctypes.c_int64)
_P_U32 = ctypes.POINTER(ctypes.c_uint32)
_P_U8 = ctypes.POINTER(ctypes.c_uint8)
_P_F64 = ctypes.POINTER(ctypes.c_double)
_P_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.c_int64
_F64 = ctypes.c_double

#: each entry point's (restype, argtypes)
_SIGNATURES = {
    "mtpu_edit_distance": (_I64, [_P_I64, _I64, _P_I64, _I64]),
    "mtpu_edit_distance_batch": (None, [_P_I64, _P_I64, _P_I64, _P_I64, _I64, _P_I64]),
    "mtpu_rle_encode": (_I64, [_P_U8, _I64, _I64, _P_U32]),
    "mtpu_rle_encode_batch": (_I64, [_P_U8, _I64, _I64, _I64, _P_U32, _P_I64]),
    "mtpu_rle_decode": (None, [_P_U32, _I64, _P_U8, _I64]),
    "mtpu_rle_area": (_I64, [_P_U32, _I64]),
    "mtpu_rle_area_batch": (None, [_P_U32, _P_I64, _I64, _P_F64]),
    "mtpu_rle_intersection": (_I64, [_P_U32, _I64, _P_U32, _I64]),
    "mtpu_lap_batch": (None, [_P_F64, _I64, _I64, _P_I64]),
    "mtpu_coco_match": (None, [_P_F64, _I64, _I64, _P_U8, _P_F64, _I64, _P_I64, _P_U8, _P_U8]),
    "mtpu_box_iou_blocks": (None, [_P_F64, _P_I64, _P_F64, _P_I64, _I64, _P_F64]),
    "mtpu_rle_iou_blocks": (None, [_P_U32, _P_I64, _P_U32, _P_I64, _P_I64, _P_I64, _I64, _P_F64]),
    "mtpu_coco_tables": (
        None, [_P_U8, _I64, _P_I64, _P_U8, _P_I64, _P_I64, _P_F64, _P_F64, _I64, _I64, _I64, _P_F64, _P_F64],
    ),
    "mtpu_coco_match_blocks": (None, [_P_F64, _P_I64, _P_I64, _I64, _P_U8, _P_F64, _I64, _I64, _P_U8]),
    "mtpu_eed_batch": (None, [_P_I32, _P_I64, _P_I32, _P_I64, _I64, _F64, _F64, _F64, _F64, _P_F64]),
}


def library_path() -> Path:
    """Where the shared library of the current sources lives once built."""
    digest = hashlib.sha256(SOURCE.read_bytes() + TEXT_SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libnative_{digest}.so"


def build() -> Path:
    """Compile the source unless its library exists; returns the library's path.  Raises when
    ``g++`` fails or is missing."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")  # concurrent builds never share a file
        subprocess.run(
            ["g++", "-O3", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17", str(SOURCE), str(TEXT_SOURCE),
             "-o", str(tmp)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if it is missing; ``None`` where it cannot be built."""
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, subprocess.SubprocessError):
        return None
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def native_available() -> bool:
    return get_lib() is not None


def _ptr(array: np.ndarray, pointer_type):
    return array.ctypes.data_as(pointer_type)


def _i64(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.int64)


# ---------------------------------------------------------------------------
# Edit distance
# ---------------------------------------------------------------------------
def _intern(*seqs: Sequence[str]) -> List[np.ndarray]:
    table: dict = {}
    out = []
    for seq in seqs:
        ids = np.empty(len(seq), dtype=np.int64)
        for i, tok in enumerate(seq):
            ids[i] = table.setdefault(tok, len(table))
        out.append(ids)
    return out


def _edit_distance_py(a: np.ndarray, b: np.ndarray) -> int:
    """Two-row DP fallback (vectorized inner loop over numpy)."""
    na, nb = len(a), len(b)
    if na == 0:
        return nb
    if nb == 0:
        return na
    prev = np.arange(nb + 1, dtype=np.int64)
    for i in range(1, na + 1):
        cur = np.empty(nb + 1, dtype=np.int64)
        cur[0] = i
        sub = prev[:-1] + (a[i - 1] != b)
        dele = prev[1:] + 1
        best = np.minimum(sub, dele)
        # the insertion column carries a sequential dependency: a running-min
        # scan, cur[j] = min(best[j-1], cur[j-1]+1)
        run = cur[0]
        for j in range(1, nb + 1):
            run = min(run + 1, best[j - 1])
            cur[j] = run
        prev = cur
    return int(prev[nb])


def edit_distance(pred_tokens: Sequence[str], target_tokens: Sequence[str]) -> int:
    """Levenshtein distance between two token sequences (words or chars)."""
    a, b = _intern(pred_tokens, target_tokens)
    lib = get_lib()
    if lib is not None:
        return int(lib.mtpu_edit_distance(_ptr(a, _P_I64), len(a), _ptr(b, _P_I64), len(b)))
    return _edit_distance_py(a, b)


def edit_distance_batch(preds: Sequence[Sequence[str]], targets: Sequence[Sequence[str]]) -> np.ndarray:
    """Per-pair Levenshtein distances in one native call."""
    if len(preds) != len(targets):
        raise ValueError(f"edit_distance_batch takes as many targets as predictions, got {len(preds)} and {len(targets)}")
    n = len(preds)
    lib = get_lib()
    if lib is None or n == 0:
        return np.asarray([edit_distance(p, t) for p, t in zip(preds, targets)], dtype=np.int64)
    interned = _intern(*preds, *targets)
    a_ids, b_ids = interned[:n], interned[n:]
    a_flat = _i64(np.concatenate(a_ids))
    b_flat = _i64(np.concatenate(b_ids))
    a_lens = np.asarray([len(x) for x in a_ids], dtype=np.int64)
    b_lens = np.asarray([len(x) for x in b_ids], dtype=np.int64)
    out = np.empty(n, dtype=np.int64)
    lib.mtpu_edit_distance_batch(
        _ptr(a_flat, _P_I64), _ptr(a_lens, _P_I64), _ptr(b_flat, _P_I64), _ptr(b_lens, _P_I64), n, _ptr(out, _P_I64)
    )
    return out


def _code_points(texts: Sequence[str]) -> np.ndarray:
    return np.frombuffer("".join(texts).encode("utf-32-le"), dtype=np.int32)


def eed_batch(
    hyps: Sequence[str], refs: Sequence[str], alpha: float, rho: float, deletion: float, insertion: float
) -> Optional[np.ndarray]:
    """Each (hyp, ref) pair's extended edit distance in one native call (float64), or ``None`` where the
    library is missing: the caller then runs its Python grid, which gives the same bits."""
    if len(hyps) != len(refs):
        raise ValueError(f"eed_batch takes as many references as hypotheses, got {len(hyps)} and {len(refs)}")
    lib = get_lib()
    if lib is None:
        return None
    h, r = _code_points(hyps), _code_points(refs)
    h_lens = np.asarray([len(x) for x in hyps], dtype=np.int64)
    r_lens = np.asarray([len(x) for x in refs], dtype=np.int64)
    out = np.empty(len(hyps), dtype=np.float64)
    lib.mtpu_eed_batch(_ptr(h, _P_I32), _ptr(h_lens, _P_I64), _ptr(r, _P_I32), _ptr(r_lens, _P_I64), len(hyps),
                       alpha, rho, deletion, insertion, _ptr(out, _P_F64))
    return out


# ---------------------------------------------------------------------------
# COCO greedy matching, block IoUs and precision tables
# ---------------------------------------------------------------------------
def coco_match(ious: np.ndarray, gt_ignore: np.ndarray, thresholds: np.ndarray):
    """Greedy COCO matching across all thresholds; None if no native lib.

    Args: ious (n_det, n_gt) float64 (dets score-sorted, gts
    non-ignored-first), gt_ignore (n_gt,) bool, thresholds (T,) float64.
    Returns (det_match (T, n_det) int64, det_ignore (T, n_det) bool,
    gt_matched (T, n_gt) bool).
    """
    lib = get_lib()
    if lib is None:
        return None
    ious = np.ascontiguousarray(ious, dtype=np.float64)
    gt_ignore_u8 = np.ascontiguousarray(gt_ignore, dtype=np.uint8)
    thresholds = np.ascontiguousarray(thresholds, dtype=np.float64)
    n_det, n_gt = ious.shape
    T = len(thresholds)
    det_match = np.empty((T, n_det), dtype=np.int64)
    det_ignore = np.zeros((T, n_det), dtype=np.uint8)
    gt_matched = np.zeros((T, n_gt), dtype=np.uint8)
    lib.mtpu_coco_match(
        _ptr(ious, _P_F64), n_det, n_gt, _ptr(gt_ignore_u8, _P_U8), _ptr(thresholds, _P_F64), T,
        _ptr(det_match, _P_I64), _ptr(det_ignore, _P_U8), _ptr(gt_matched, _P_U8),
    )
    return det_match, det_ignore.astype(bool), gt_matched.astype(bool)


def box_iou_blocks(dboxes: np.ndarray, nd: np.ndarray, gboxes: np.ndarray, ng: np.ndarray):
    """Pairwise IoU for B independent xyxy blocks in one native call.

    Args: dboxes (sum_nd, 4) and gboxes (sum_ng, 4) float64 concatenated in
    block order; nd/ng (B,) per-block counts.  Returns the flat concatenation
    of row-major (nd[b], ng[b]) blocks, or None if no native lib.
    """
    lib = get_lib()
    if lib is None:
        return None
    nd, ng = _i64(nd), _i64(ng)
    dboxes = np.ascontiguousarray(dboxes, dtype=np.float64)
    gboxes = np.ascontiguousarray(gboxes, dtype=np.float64)
    out = np.empty(int((nd * ng).sum()), dtype=np.float64)
    lib.mtpu_box_iou_blocks(
        _ptr(dboxes, _P_F64), _ptr(nd, _P_I64), _ptr(gboxes, _P_F64), _ptr(ng, _P_I64), len(nd), _ptr(out, _P_F64)
    )
    return out


def rle_iou_blocks(
    druns: np.ndarray, drunlens: np.ndarray, gruns: np.ndarray, grunlens: np.ndarray,
    nd: np.ndarray, ng: np.ndarray,
):
    """Pairwise RLE-mask IoU for B independent blocks in one native call.

    Args: druns/gruns — all masks' uint32 run arrays concatenated in block
    order; drunlens/grunlens — per-mask run counts; nd/ng — masks per block.
    Returns the flat (nd[b], ng[b]) block concatenation, or None.
    """
    lib = get_lib()
    if lib is None:
        return None
    nd, ng = _i64(nd), _i64(ng)
    druns = np.ascontiguousarray(druns, dtype=np.uint32)
    gruns = np.ascontiguousarray(gruns, dtype=np.uint32)
    drunlens, grunlens = _i64(drunlens), _i64(grunlens)
    out = np.empty(int((nd * ng).sum()), dtype=np.float64)
    lib.mtpu_rle_iou_blocks(
        _ptr(druns, _P_U32), _ptr(drunlens, _P_I64), _ptr(gruns, _P_U32), _ptr(grunlens, _P_I64),
        _ptr(nd, _P_I64), _ptr(ng, _P_I64), len(nd), _ptr(out, _P_F64),
    )
    return out


def coco_match_blocks(
    ious_flat: np.ndarray, nd: np.ndarray, ng: np.ndarray,
    gt_ignore: np.ndarray, thresholds: np.ndarray,
):
    """Greedy COCO matching for B independent blocks in one native call.

    Args: ious_flat — concatenated row-major (nd[b], ng[b]) blocks; gt_ignore
    — concatenated per-gt flags in block order; thresholds (T,).  Returns
    codes (T, sum_nd) uint8 (0 unmatched / 1 matched counted / 2 matched
    ignored) with block b's columns at its running det offset, or None.
    """
    lib = get_lib()
    if lib is None:
        return None
    nd, ng = _i64(nd), _i64(ng)
    ious_flat = np.ascontiguousarray(ious_flat, dtype=np.float64)
    gt_ignore = np.ascontiguousarray(gt_ignore, dtype=np.uint8)
    thresholds = np.ascontiguousarray(thresholds, dtype=np.float64)
    total_det = int(nd.sum())
    codes = np.empty((len(thresholds), total_det), dtype=np.uint8)
    lib.mtpu_coco_match_blocks(
        _ptr(ious_flat, _P_F64), _ptr(nd, _P_I64), _ptr(ng, _P_I64), len(nd), _ptr(gt_ignore, _P_U8),
        _ptr(thresholds, _P_F64), len(thresholds), total_det, _ptr(codes, _P_U8),
    )
    return codes


def coco_tables(
    codes: np.ndarray, cols: np.ndarray, dout: np.ndarray,
    seg_starts: np.ndarray, seg_sizes: np.ndarray,
    npig: np.ndarray, rec_thrs: np.ndarray,
):
    """Per-class-segment precision/recall tables in one native call.

    Args: codes (T, N_full) uint8 raw match-code table; cols — column ids
    selecting and ordering the evaluated detections by (class, score desc);
    dout (N_full,) bool out-of-area flags (original column order);
    seg_starts/seg_sizes (S,) per-class segments as positions into ``cols``;
    npig (S,) counted gts per segment; rec_thrs (R,) ascending recall
    thresholds.  Returns (precision (T, R, S), recall (T, S)) with segments
    of ``npig <= 0`` zero-filled, or None if no native lib.
    """
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    cols = _i64(cols)
    dout = np.ascontiguousarray(dout, dtype=np.uint8)
    seg_starts, seg_sizes = _i64(seg_starts), _i64(seg_sizes)
    npig = np.ascontiguousarray(npig, dtype=np.float64)
    rec_thrs = np.ascontiguousarray(rec_thrs, dtype=np.float64)
    T, N = codes.shape
    S, R = len(seg_starts), len(rec_thrs)
    prec = np.zeros((T, R, S), dtype=np.float64)
    rec = np.zeros((T, S), dtype=np.float64)
    lib.mtpu_coco_tables(
        _ptr(codes, _P_U8), N, _ptr(cols, _P_I64), _ptr(dout, _P_U8), _ptr(seg_starts, _P_I64),
        _ptr(seg_sizes, _P_I64), _ptr(npig, _P_F64), _ptr(rec_thrs, _P_F64), T, S, R,
        _ptr(prec, _P_F64), _ptr(rec, _P_F64),
    )
    return prec, rec


# ---------------------------------------------------------------------------
# RLE masks (COCO column-major convention)
# ---------------------------------------------------------------------------
def rle_encode_batch(masks: np.ndarray):
    """Encode a stacked (N, H, W) mask tensor in one native call.

    Returns (runs, runcounts): all masks' uncompressed column-major RLE run
    arrays concatenated, plus per-mask run counts — exactly the segm state
    layout of ``MeanAveragePrecision``.  Falls back to per-mask encodes
    without the native lib.
    """
    masks = np.ascontiguousarray(masks, dtype=np.uint8)
    if masks.ndim != 3:
        raise ValueError(f"rle_encode_batch expects (N, H, W), got {masks.shape}")
    n, h, w = masks.shape
    lib = get_lib()
    if lib is None or n == 0:
        rles = [rle_encode(m) for m in masks]
        runs = np.concatenate(rles) if rles else np.zeros(0, np.uint32)
        return runs, np.asarray([len(r) for r in rles], np.int64)
    # room for the worst case, n * (h * w + 1) runs: np.empty maps pages lazily,
    # so only the runs written are touched
    runs = np.empty(max(n * (h * w + 1), 1), dtype=np.uint32)
    runcounts = np.empty(n, dtype=np.int64)
    total = lib.mtpu_rle_encode_batch(_ptr(masks, _P_U8), n, h, w, _ptr(runs, _P_U32), _ptr(runcounts, _P_I64))
    return runs[:total].copy(), runcounts


def rle_encode(mask: np.ndarray) -> np.ndarray:
    """Binary HxW mask -> uncompressed RLE counts (column-major, 0-run first)."""
    mask = np.ascontiguousarray(np.asfortranarray(mask.astype(np.uint8)).ravel(order="F"))
    lib = get_lib()
    if lib is not None:
        counts = np.empty(mask.size + 1, dtype=np.uint32)
        n_runs = lib.mtpu_rle_encode(_ptr(mask, _P_U8), mask.size, 1, _ptr(counts, _P_U32))
        return counts[:n_runs].copy()
    flat = mask
    if flat.size == 0:
        return np.asarray([0], dtype=np.uint32)
    change = np.flatnonzero(np.diff(flat)) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    runs = np.diff(bounds).astype(np.uint32)
    if flat[0] == 1:
        runs = np.concatenate([[np.uint32(0)], runs])
    return runs


def rle_decode(counts: np.ndarray, shape: tuple) -> np.ndarray:
    """Uncompressed RLE counts -> binary mask of `shape` (column-major)."""
    n = int(np.prod(shape))
    counts = np.ascontiguousarray(counts, dtype=np.uint32)
    lib = get_lib()
    if lib is not None:
        flat = np.empty(n, dtype=np.uint8)
        lib.mtpu_rle_decode(_ptr(counts, _P_U32), len(counts), _ptr(flat, _P_U8), n)
    else:
        flat = np.zeros(n, dtype=np.uint8)
        pos, v = 0, 0
        for c in counts:
            end = min(pos + int(c), n)
            if v:
                flat[pos:end] = 1
            pos = end
            v = 1 - v
    return flat.reshape(shape, order="F")


def rle_area(counts: np.ndarray) -> int:
    counts = np.ascontiguousarray(counts, dtype=np.uint32)
    lib = get_lib()
    if lib is not None:
        return int(lib.mtpu_rle_area(_ptr(counts, _P_U32), len(counts)))
    return int(counts[1::2].sum())


def rle_area_batch(runs: np.ndarray, runcounts: np.ndarray):
    """Per-mask areas over concatenated run arrays; None if no native lib."""
    lib = get_lib()
    if lib is None:
        return None
    runs = np.ascontiguousarray(runs, dtype=np.uint32)
    runcounts = _i64(runcounts)
    out = np.empty(len(runcounts), dtype=np.float64)
    lib.mtpu_rle_area_batch(_ptr(runs, _P_U32), _ptr(runcounts, _P_I64), len(runcounts), _ptr(out, _P_F64))
    return out


def rle_iou(a: np.ndarray, b: np.ndarray, iscrowd_b: bool = False) -> float:
    """IoU of two RLE masks over the same canvas; crowd GT uses area(a) denom."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    b = np.ascontiguousarray(b, dtype=np.uint32)
    lib = get_lib()
    if lib is not None:
        inter = int(lib.mtpu_rle_intersection(_ptr(a, _P_U32), len(a), _ptr(b, _P_U32), len(b)))
    else:
        pos_a = np.cumsum(a)
        pos_b = np.cumsum(b)
        n = int(min(pos_a[-1] if len(pos_a) else 0, pos_b[-1] if len(pos_b) else 0))
        ma = rle_decode(a, (n,)) if n else np.zeros(0, np.uint8)
        mb = rle_decode(b, (n,)) if n else np.zeros(0, np.uint8)
        inter = int(np.logical_and(ma, mb).sum())
    area_a, area_b = rle_area(a), rle_area(b)
    denom = area_a if iscrowd_b else (area_a + area_b - inter)
    return inter / denom if denom > 0 else 0.0


# ---------------------------------------------------------------------------
# Linear assignment (Jonker-Volgenant shortest augmenting paths)
# ---------------------------------------------------------------------------
def _lap_py(cost: np.ndarray) -> np.ndarray:
    """Pure-Python JV fallback: min-cost assignment of one (n, n) matrix.

    Same algorithm as the native ``mtpu_lap_batch`` kernel: dual potentials
    u/v plus shortest augmenting paths, O(n^3).
    """
    n = cost.shape[0]
    INF = float("inf")
    u = [0.0] * (n + 1)
    v = [0.0] * (n + 1)
    p = [0] * (n + 1)
    way = [0] * (n + 1)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = [INF] * (n + 1)
        used = [False] * (n + 1)
        while True:
            used[j0] = True
            i0, j1, delta = p[j0], 0, INF
            for j in range(1, n + 1):
                if used[j]:
                    continue
                cur = cost[i0 - 1, j - 1] - u[i0] - v[j]
                if cur < minv[j]:
                    minv[j] = cur
                    way[j] = j0
                if minv[j] < delta:
                    delta = minv[j]
                    j1 = j
            for j in range(n + 1):
                if used[j]:
                    u[p[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    out = np.empty(n, dtype=np.int64)
    for j in range(1, n + 1):
        if p[j]:
            out[p[j] - 1] = j - 1
    return out


def lap_batch(cost: np.ndarray) -> np.ndarray:
    """Min-cost linear assignment for a batch of square matrices.

    Args: cost (batch, n, n) — ``out[b, i]`` is the column assigned to row i.
    The host path for large n of the audio metrics' permutation search, in
    place of scipy's ``linear_sum_assignment``.
    """
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    if cost.ndim != 3 or cost.shape[1] != cost.shape[2]:
        raise ValueError(f"lap_batch expects (batch, n, n), got {cost.shape}")
    if not np.isfinite(cost).all():
        # NaN would make every dual comparison false and hang the
        # augmenting-path loop (scipy raises on this input too)
        raise ValueError("lap_batch: cost matrix contains non-finite entries")
    batch, n = cost.shape[0], cost.shape[1]
    if n == 0 or batch == 0:
        return np.zeros((batch, n), dtype=np.int64)
    lib = get_lib()
    if lib is not None:
        out = np.empty((batch, n), dtype=np.int64)
        lib.mtpu_lap_batch(_ptr(cost, _P_F64), batch, n, _ptr(out, _P_I64))
        return out
    return np.stack([_lap_py(cost[b]) for b in range(batch)])
