"""The device route of the COCO mAP inner loops (counterpart of ``metrics_tpu/detection/device.py``).

``MeanAveragePrecision(on_device=True)`` hands its three hot loops to these
functions over **fixed-capacity padded** operands: the intersections of the
segm IoUs over RLE runs, the greedy matcher and the precision/recall score
tables (and the intersections and unions of the box IoUs).  Each takes
tensors and returns tensors on their device: the card, or the CPU, where the
same torch operations run and the matcher takes its plain version.

Exact-decision design
---------------------
The host route decides in float64; these work in int32 and float32, so each
is built so that every *discrete* output is bit-exact against the host route
and only *values* carry float32 rounding:

* **segm IoU** returns exact int32 run-overlap counts (pixel counts fit int32
  for any COCO canvas); the caller divides on the host in float64.
* the **matcher** never sees a float: the caller rank-transforms the float64
  IoUs (``np.unique`` + ``searchsorted``: order isomorphic, tie-exact) and
  the kernel (``ops/coco_match.py``) runs the greedy protocol on int32 ranks.
* the **tables** compare integer TP cumsums against host-derived integer
  recall cutoffs (``k_min``), so the 101-point interpolation picks the same
  columns as the float64 host route; only the precision *values* are float32.

Padding contract (every function):

* run tables are ``(n_masks, R)`` int32 with zero-length runs appended: a
  zero run is an empty interval and contributes nothing;
* rank blocks are ``(B, D, G)`` with ``-1`` marking absent det/gt slots
  (below any threshold rank, so padding can never match);
* code grids are ``(T, S, L)`` with an explicit validity mask.

The capacities come from :func:`bucket`, a bounded ladder, as in the JAX
package, where it keeps the jit cache warm; here it bounds the padding.
"""

from typing import Tuple

import torch

from metrics_tpu_torch.ops.coco_match import coco_match

__all__ = [
    "segm_intersections",
    "box_inter_union",
    "match_ranked_blocks",
    "score_tables",
    "bucket",
]


def bucket(n: int, lo: int = 8) -> int:
    """Smallest capacity >= max(n, lo) from a fixed geometric grid.

    Capacities are ``2^k`` refined by quarter-steps (``1.25/1.5/1.75 * 2^k``)
    once above ``4*lo``: a bounded shape set that wastes at most ~25% padding
    instead of the ~2x a pure power-of-two ladder can cost.
    """
    n = max(int(n), 1)
    p = lo
    while p < n:
        p *= 2
    if p >= 4 * lo:
        for frac in (10, 12, 14):  # p/2 * 1.25, 1.5, 1.75
            cand = (p * frac) // 16
            if cand >= n:
                return cand
    return p


def segm_intersections(
    d_runs_pad: torch.Tensor, g_runs_pad: torch.Tensor, pair_d: torch.Tensor, pair_g: torch.Tensor
) -> torch.Tensor:
    """Exact per-pair mask intersections (pixel counts, ``(P,)`` int32).

    ``d_runs_pad``/``g_runs_pad`` are ``(n_masks, R)`` int32 zero-padded run
    tables (``R`` even); ``pair_d``/``pair_g`` ``(P,)`` index rows.  Each pair
    lies on one image's canvas.  Run ``k`` of a mask covers ``[bounds[k-1],
    bounds[k])`` in column-major pixel order, zero run first; odd runs are
    foreground.  The gt's foreground coverage is evaluated at every det run
    boundary by one batched ``searchsorted`` over the pairs' rows, and each det
    foreground interval adds the difference of its ends' coverage, every term
    in ``[0, canvas area]``, so the int32 sum cannot overflow.
    """
    d_bounds = torch.cumsum(d_runs_pad, dim=1, dtype=torch.int32)
    g_bounds = torch.cumsum(g_runs_pad, dim=1, dtype=torch.int32)
    n_runs = d_runs_pad.shape[1]
    odd = (torch.arange(n_runs, device=g_runs_pad.device) & 1) == 1
    # fg_prefix[k] = foreground pixels in runs < k, with a leading 0 column
    g_fgp = torch.cat(
        [torch.zeros((g_runs_pad.shape[0], 1), dtype=torch.int32, device=g_runs_pad.device),
         torch.cumsum(torch.where(odd, g_runs_pad, 0), dim=1, dtype=torch.int32)],
        dim=1,
    )
    db = d_bounds[pair_d]  # (P, R): the det's run boundaries
    gb = g_bounds[pair_g]
    k = torch.searchsorted(gb, db, right=True)  # the gt run holding each boundary
    prev = torch.where(k > 0, torch.gather(gb, 1, (k - 1).clamp(min=0)), 0)
    partial = torch.where((k & 1) == 1, db - prev, 0)
    cov = torch.gather(g_fgp[pair_g], 1, k) + partial
    return (cov[:, 1::2] - cov[:, 0::2]).sum(dim=1).to(torch.int32)


def box_inter_union(dboxes: torch.Tensor, gboxes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pair box (intersection, union) of ``(P, 4)`` xyxy boxes, in float32; the caller divides in
    float64.

    Integer-coordinate boxes with areas below 2**24 stay exact in float32, so
    the host route's IoU reproduces bit for bit on such inputs; float
    coordinates carry ~1e-7 relative rounding.
    """
    dboxes, gboxes = dboxes.to(torch.float32), gboxes.to(torch.float32)
    lt = torch.maximum(dboxes[:, :2], gboxes[:, :2])
    rb = torch.minimum(dboxes[:, 2:], gboxes[:, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[:, 0] * wh[:, 1]
    area_d = (dboxes[:, 2] - dboxes[:, 0]) * (dboxes[:, 3] - dboxes[:, 1])
    area_g = (gboxes[:, 2] - gboxes[:, 0]) * (gboxes[:, 3] - gboxes[:, 1])
    return inter, area_d + area_g - inter


def match_ranked_blocks(ranks: torch.Tensor, gt_ignore: torch.Tensor, thr_ranks: torch.Tensor) -> torch.Tensor:
    """Greedy COCO matching over ``B`` padded blocks, all area ranges and thresholds in one call.

    ``ranks (B, D, G)`` int32 holds the rank of each det x gt IoU in the
    epoch's sorted-unique float64 IoU table (``-1`` marks padding);
    ``gt_ignore (A, B, G)`` bool the per-area-range gt ignore flags;
    ``thr_ranks (T,)`` int32 the rank cutoffs of the IoU thresholds.  Rank
    space preserves every comparison and tie of the float64 protocol, so the
    codes ``(A, B, T, D)`` uint8 (0 unmatched / 1 matched counted / 2 matched
    ignored) are bit-exact against the host matcher.  CUDA tensors launch
    the ``coco_match`` kernel; CPU tensors take its plain version.
    """
    return coco_match(ranks.contiguous(), gt_ignore.contiguous(), thr_ranks.contiguous())


def score_tables(
    codes_grid: torch.Tensor,
    valid: torch.Tensor,
    dout_grid: torch.Tensor,
    k_min: torch.Tensor,
    sizes: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class-segment precision tables and final TP counts.

    ``codes_grid (A, T, S, L)`` uint8 match codes laid out one class segment
    per row in (score desc) order, ``valid (S, L)`` bool the padding mask
    (shared across area ranges), ``dout_grid (A, S, L)`` bool out-of-area
    flags, ``k_min (A, S, R)`` int32 minimal TP counts per recall threshold
    (host-derived in float64), ``sizes (S,)`` int32 actual segment lengths.
    Returns ``(precision (A, T, R, S) float32, tp_last (A, T, S) int32)``;
    recall is ``tp_last / npig``, divided on the host in float64.  All four
    area ranges in one pass.
    """
    n_areas, n_thr, n_seg, length = codes_grid.shape
    valid = valid[None, None]
    tp = torch.cumsum((codes_grid == 1) & valid, dim=-1, dtype=torch.int32)
    fp = torch.cumsum((codes_grid == 0) & ~dout_grid[:, None] & valid, dim=-1, dtype=torch.int32)
    denom = tp + fp
    pr = torch.where(denom > 0, tp.to(torch.float32) / denom.clamp(min=1).to(torch.float32), 0.0)
    # monotone non-increasing precision envelope
    pr = torch.flip(torch.cummax(torch.flip(pr, dims=(-1,)), dim=-1).values, dims=(-1,))
    # the first column whose integer TP count reaches each recall cutoff: the
    # column float64 searchsorted over tp/npig picks, since k_min is the least
    # integer k with f64(k/npig) >= rec_thr
    cutoffs = k_min[:, None].expand(n_areas, n_thr, n_seg, k_min.shape[-1]).contiguous()
    idx = torch.searchsorted(tp, cutoffs)  # (A, T, S, R)
    ok = idx < sizes.view(1, 1, -1, 1)
    prec = torch.where(ok, torch.gather(pr, -1, idx.clamp(max=length - 1)), 0.0)
    return prec.permute(0, 1, 3, 2), tp[..., length - 1]
