"""Retrieval engine: every query scored at once
(counterpart of ``metrics_tpu/functional/retrieval/engine.py``).

1. one stable sort orders every document by ``(query, -pred)``;
2. ranks within a query come from the queries' offsets;
3. each metric is a few sums (or a min) over the queries' contiguous
   segments of the sorted rows.

The sort key is one int64 per row: the query in the high word and, in the
low word, the order key of ``-pred`` that the JAX package's ``lexsort``
compares (``-0.0`` equal to ``+0.0``, every NaN above ``+inf``); ties keep
the input order.  Segment sums run over contiguous segments
(``torch.segment_reduce``), so two runs on one device add in one order and
agree bit for bit; counts of 0/1 targets are exact below 2^24 rows.
"""

from typing import Optional, Tuple

import torch

from metrics_tpu_torch.functional.classification.precision_recall_curve import _sort_keys
from metrics_tpu_torch.utils.compute import _mean


def contiguous_groups(indexes: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Query ids remapped to ``0..n_groups-1`` in ascending id order, on their device.

    ``n_groups`` is one device->host read.
    """
    values, inverse = torch.unique(indexes.reshape(-1), sorted=True, return_inverse=True)
    return inverse, int(values.numel())


def _order_by(group: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """The stable order of ``(group, -scores)``, as ``jnp.lexsort((-scores, group))`` gives it."""
    low = _sort_keys(-scores).to(torch.int64) + 2**31  # int32 order keys as non-negative
    return torch.sort((group.to(torch.int64) << 32) | low, stable=True).indices


def _segment_sum(values: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Sums over the contiguous segments of ``counts`` rows each."""
    return torch.segment_reduce(values, "sum", lengths=counts, unsafe=True)


def _group_counts(group: torch.Tensor, n_groups: int) -> torch.Tensor:
    return torch.zeros(n_groups, dtype=torch.int64, device=group.device).index_add_(0, group, torch.ones_like(group))


def _group_layout(preds: torch.Tensor, group: torch.Tensor, n_groups: int):
    """Sort by (group, -pred); returns the order, the sorted group ids, 0-based ranks
    within each group, the groups' row counts and their first sorted rows."""
    group = group.to(torch.int64)
    order = _order_by(group, preds)
    g = group[order]
    counts = _group_counts(group, n_groups)
    starts = counts.cumsum(0) - counts
    rank = torch.arange(group.shape[0], device=group.device) - starts[g]
    return order, g, rank, counts, starts


def group_relevant_counts(target: torch.Tensor, group: torch.Tensor, n_groups: int) -> torch.Tensor:
    """The sum of each group's targets (float32)."""
    out = torch.zeros(n_groups, dtype=torch.float32, device=target.device)
    return out.index_add_(0, group.to(torch.int64), target.to(torch.float32))


def average_precision_per_group(preds: torch.Tensor, target: torch.Tensor, group: torch.Tensor, n_groups: int) -> torch.Tensor:
    """AP per query.  The running hit count is a float32 ``cumsum`` over all rows,
    as in the JAX package: exact below 2^24 relevant rows."""
    order, g, rank, counts, starts = _group_layout(preds, group, n_groups)
    t = target[order].to(torch.float32)
    cs = torch.cumsum(t, 0)
    base = torch.where(starts > 0, cs[(starts - 1).clamp(min=0)], torch.zeros_like(cs[:1]))
    hits_so_far = cs - base[g]
    prec_at_hit = torch.where(t > 0, hits_so_far / (rank + 1.0), torch.zeros_like(t))
    n_rel = _segment_sum(t, counts)
    return _segment_sum(prec_at_hit, counts) / n_rel.clamp(min=1.0)


def reciprocal_rank_per_group(preds: torch.Tensor, target: torch.Tensor, group: torch.Tensor, n_groups: int) -> torch.Tensor:
    """RR per query: one over the rank of its first relevant document, 0 without one."""
    order, _, rank, counts, _ = _group_layout(preds, group, n_groups)
    t = target[order]
    masked_rank = torch.where(t > 0, (rank + 1).to(torch.float32), torch.full_like(rank, float("inf"), dtype=torch.float32))
    first = torch.segment_reduce(masked_rank, "min", lengths=counts, unsafe=True)
    return torch.where(torch.isfinite(first), 1.0 / first, torch.zeros_like(first))


def precision_per_group(
    preds: torch.Tensor, target: torch.Tensor, group: torch.Tensor, n_groups: int,
    k: Optional[int] = None, adaptive_k: bool = False,
) -> torch.Tensor:
    """Precision@k per query."""
    order, _, rank, counts, _ = _group_layout(preds, group, n_groups)
    t = target[order].to(torch.float32)
    countsf = counts.to(torch.float32)
    if k is None:
        hits = _segment_sum(t, counts)
        denom = countsf
    else:
        hits = _segment_sum(t * (rank < k), counts)
        kf = torch.full_like(countsf, float(k))
        denom = torch.minimum(kf, countsf) if adaptive_k else kf
    return hits / denom.clamp(min=1.0)


def recall_per_group(
    preds: torch.Tensor, target: torch.Tensor, group: torch.Tensor, n_groups: int, k: Optional[int] = None
) -> torch.Tensor:
    """Recall@k per query."""
    order, _, rank, counts, _ = _group_layout(preds, group, n_groups)
    t = target[order].to(torch.float32)
    hits = _segment_sum(t if k is None else t * (rank < k), counts)
    return hits / _segment_sum(t, counts).clamp(min=1.0)


def fall_out_per_group(
    preds: torch.Tensor, target: torch.Tensor, group: torch.Tensor, n_groups: int, k: Optional[int] = None
) -> torch.Tensor:
    """Fall-out@k per query: the share of its non-relevant documents in its top k."""
    order, _, rank, counts, _ = _group_layout(preds, group, n_groups)
    neg = 1.0 - target[order].to(torch.float32)
    neg_hits = _segment_sum(neg if k is None else neg * (rank < k), counts)
    return neg_hits / _segment_sum(neg, counts).clamp(min=1.0)


def hit_rate_per_group(
    preds: torch.Tensor, target: torch.Tensor, group: torch.Tensor, n_groups: int, k: Optional[int] = None
) -> torch.Tensor:
    """HitRate@k per query: 1 where a relevant document is in its top k."""
    order, _, rank, counts, _ = _group_layout(preds, group, n_groups)
    t = target[order].to(torch.float32)
    hits = _segment_sum(t if k is None else t * (rank < k), counts)
    return (hits > 0).to(torch.float32)


def r_precision_per_group(preds: torch.Tensor, target: torch.Tensor, group: torch.Tensor, n_groups: int) -> torch.Tensor:
    """R-Precision per query: precision in its top R, R its number of relevant documents."""
    order, g, rank, counts, _ = _group_layout(preds, group, n_groups)
    t = target[order].to(torch.float32)
    n_rel = _segment_sum(t, counts)
    hits = _segment_sum(t * (rank < n_rel[g]), counts)
    return hits / n_rel.clamp(min=1.0)


def ndcg_per_group(
    preds: torch.Tensor, target: torch.Tensor, group: torch.Tensor, n_groups: int, k: Optional[int] = None
) -> torch.Tensor:
    """nDCG@k per query, graded targets allowed.

    The ideal order reuses the rank array: ranks depend only on the groups'
    offsets, which both orders share.  ``1 / log2(rank + 2)`` may differ from
    XLA's in the last bit.
    """
    tf = target.to(torch.float32)
    order, _, rank, counts, _ = _group_layout(preds, group, n_groups)
    disc = 1.0 / torch.log2(rank.to(torch.float32) + 2.0)
    if k is not None:
        disc = disc * (rank < k)
    dcg = _segment_sum(tf[order] * disc, counts)
    idcg = _segment_sum(tf[_order_by(group.to(torch.int64), tf)] * disc, counts)
    positive = idcg > 0
    return torch.where(positive, dcg / torch.where(positive, idcg, torch.ones_like(idcg)), torch.zeros_like(dcg))


def precision_recall_curve_per_group(
    preds: torch.Tensor, target: torch.Tensor, group: torch.Tensor, n_groups: int,
    max_k: int, adaptive_k: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(precision, recall) at k = 1..max_k per query, each ``(n_groups, max_k)``.

    The (query, rank) hit table is a scatter of 0/1 values (exact), and one
    cumulative sum along the ranks gives every top-k count.
    """
    order, g, rank, counts, _ = _group_layout(preds, group, n_groups)
    t = target[order].to(torch.float32)
    table = torch.zeros((n_groups, max_k), dtype=torch.float32, device=t.device)
    table.index_put_((g, rank.clamp(max=max_k - 1)), torch.where(rank < max_k, t, torch.zeros_like(t)), accumulate=True)
    rel = torch.cumsum(table, dim=1)
    topk = torch.arange(1, max_k + 1, dtype=torch.float32, device=t.device)
    if adaptive_k:
        denom = torch.minimum(topk[None, :], counts.to(torch.float32)[:, None])
    else:
        denom = topk[None, :].expand(n_groups, max_k)
    n_rel = _segment_sum(t, counts)
    return rel / denom.clamp(min=1.0), rel / n_rel.clamp(min=1.0)[:, None]


def reduce_over_groups(
    scores: torch.Tensor,
    empty: torch.Tensor,
    empty_target_action: str,
    empty_kind: str = "positive",
) -> torch.Tensor:
    """Apply the empty-target policy per query, then take the mean over queries.

    ``scores`` is ``(n_groups,)`` or ``(n_groups, K)``, ``empty`` a ``(n_groups,)``
    bool mask; ``empty_kind`` names the missing target class in the error
    (a fall-out query is empty when it lacks *negative* targets).
    """
    if empty_target_action == "error":
        if bool(empty.any()):
            raise ValueError(f"`compute` method was provided with a query with no {empty_kind} target.")
        return _mean(scores, dim=0)
    emask = empty if scores.ndim == 1 else empty[:, None]
    if empty_target_action == "pos":
        return _mean(torch.where(emask, torch.ones_like(scores), scores), dim=0)
    if empty_target_action == "neg":
        return _mean(torch.where(emask, torch.zeros_like(scores), scores), dim=0)
    valid = (~empty).to(scores.dtype)
    n_valid = valid.sum()
    vmask = valid if scores.ndim == 1 else valid[:, None]
    out = (scores * vmask).sum(0) / n_valid.clamp(min=1.0)
    return torch.where(n_valid > 0, out, torch.zeros_like(out))
