"""Multilabel ranking functionals
(counterpart of ``metrics_tpu/functional/classification/ranking.py``).

Each metric is a vectorised reduction over the ``(N, L)`` scores, as in
the JAX package.  Label-ranking average precision compares every pair of
labels of a row, ``(rows, L, L)``; the rows go in chunks whose comparisons
stay under a fixed size, which leaves each row's result unchanged.
"""

from typing import Optional, Tuple

import torch

from metrics_tpu_torch.functional.classification.precision_recall_curve import _sort_keys
from metrics_tpu_torch.utils.checks import _as_tensor

_CHUNK_ELEMENTS = 1 << 24  # elements of one (rows, L, L) comparison


def _ranking_inputs(
    preds, target, sample_weight=None
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    preds, target = _as_tensor(preds), _as_tensor(target)
    if sample_weight is not None:
        sample_weight = _as_tensor(sample_weight)
    if preds.ndim != 2 or target.ndim != 2:
        raise ValueError(
            "Expected both predictions and target to matrices of shape `[N,C]`"
            f" but got {preds.ndim} and {target.ndim}"
        )
    if preds.shape != target.shape:
        raise ValueError("Expected both predictions and target to have same shape")
    if sample_weight is not None and (sample_weight.ndim != 1 or sample_weight.shape[0] != preds.shape[0]):
        raise ValueError(
            "Expected sample weights to be 1 dimensional and have same size"
            f" as the first dimension of preds and target but got {tuple(sample_weight.shape)}"
        )
    return preds, target, sample_weight


def _weighted_sum(
    per_sample: torch.Tensor, sample_weight: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, int, Optional[torch.Tensor]]:
    """The batch's sum of ``per_sample``, its sample count, and its summed weight."""
    n = per_sample.numel()
    if sample_weight is not None:
        per_sample = per_sample * sample_weight
        sample_weight = sample_weight.sum()
    return per_sample.sum(), n, sample_weight


def _ranking_compute(measure: torch.Tensor, n_elements: int, sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    # the count as a tensor on the card: CUDA divides by a host scalar as a product with its
    # reciprocal, one bit off the true quotient that the CPU and the JAX package give
    n_elements = torch.tensor(n_elements, dtype=measure.dtype, device=measure.device)
    if sample_weight is not None:
        zero = sample_weight == 0
        return torch.where(zero, measure / n_elements, measure / torch.where(zero, 1.0, sample_weight))
    return measure / n_elements


# ------------------------------------------------------------------ coverage
def _coverage_per_sample(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """How many labels score at least the lowest relevant one (float32 ``(N,)``).

    ``big`` spans the whole batch, so a NaN or ``-inf`` anywhere in it changes every row."""
    big = torch.abs(preds.min()) + 10
    preds_mod = preds + torch.where(target == 0, big, 0.0)
    preds_min = preds_mod.amin(1)
    return (preds >= preds_min[:, None]).sum(1).to(torch.float32)


def _coverage_error_update(
    preds: torch.Tensor, target: torch.Tensor, sample_weight: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, int, Optional[torch.Tensor]]:
    preds, target, sample_weight = _ranking_inputs(preds, target, sample_weight)
    return _weighted_sum(_coverage_per_sample(preds, target), sample_weight)


_coverage_error_compute = _ranking_compute


def coverage_error(preds: torch.Tensor, target: torch.Tensor, sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Average number of top-ranked labels needed to cover all true labels, on the device of the inputs.

    Example:
        >>> import torch
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.35]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> round(float(coverage_error(preds, target)), 6)
        1.333333
    """
    coverage, n_elements, sample_weight = _coverage_error_update(preds, target, sample_weight)
    return _coverage_error_compute(coverage, n_elements, sample_weight)


# ------------------------------------------------------ ranking average precision
def _lrap_ranks(preds: torch.Tensor, relevant: torch.Tensor, chunk_elements: int = _CHUNK_ELEMENTS):
    """float32 ``(N, L)`` ranks of each label among all labels and among the relevant
    ones: how many score at least as high (ties count, a NaN counts nowhere)."""
    n, n_labels = preds.shape
    rows = max(1, chunk_elements // max(1, n_labels * n_labels))
    rank_all = torch.empty((n, n_labels), dtype=torch.float32, device=preds.device)
    rank_rel = torch.empty_like(rank_all)
    for start in range(0, n, rows):
        p = preds[start : start + rows]
        ge = p[:, None, :] >= p[:, :, None]  # ge[i, j, k] = p_ik >= p_ij
        rank_all[start : start + rows] = ge.sum(2)
        rank_rel[start : start + rows] = (ge & relevant[start : start + rows, None, :]).sum(2)
    return rank_all, rank_rel


def _lrap_per_sample(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Each row's mean, over its relevant labels, of the share of relevant labels ranked at or
    above it; 1.0 for a row with no relevant label or only relevant labels."""
    n_labels = preds.shape[1]
    relevant = target == 1
    rank_all, rank_rel = _lrap_ranks(preds, relevant)
    n_rel = relevant.sum(1)
    per_label = torch.where(relevant, rank_rel / rank_all, 0.0)
    scored = (n_rel > 0) & (n_rel < n_labels)
    return torch.where(scored, per_label.sum(1) / torch.clamp(n_rel, min=1), 1.0)


def _label_ranking_average_precision_update(
    preds: torch.Tensor, target: torch.Tensor, sample_weight: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, int, Optional[torch.Tensor]]:
    preds, target, sample_weight = _ranking_inputs(preds, target, sample_weight)
    return _weighted_sum(_lrap_per_sample(preds, target), sample_weight)


_label_ranking_average_precision_compute = _ranking_compute


def label_ranking_average_precision(
    preds: torch.Tensor, target: torch.Tensor, sample_weight: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mean share of relevant labels ranked at or above each relevant label, on the device of the inputs.

    Example:
        >>> import torch
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.35]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> round(float(label_ranking_average_precision(preds, target)), 6)
        1.0
    """
    score, n, sample_weight = _label_ranking_average_precision_update(preds, target, sample_weight)
    return _label_ranking_average_precision_compute(score, n, sample_weight)


# ------------------------------------------------------------ ranking loss
def _rank_inverse(preds: torch.Tensor) -> torch.Tensor:
    """Each label's position in its row's stable ascending order: ``argsort(argsort(preds))``
    as ``jnp.argsort`` orders, with ``-0.0`` level with ``+0.0`` and every NaN last."""
    order = torch.sort(_sort_keys(preds), dim=1, stable=True).indices
    positions = torch.arange(preds.shape[1], device=preds.device).expand_as(order)
    return torch.empty_like(order).scatter_(1, order, positions)


def _lrl_per_sample(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Each row's share of (relevant, irrelevant) label pairs ordered wrong, ties broken by
    position; 0.0 for a row with no relevant label or only relevant labels."""
    n_labels = preds.shape[1]
    relevant = target == 1
    n_relevant = relevant.sum(1)
    valid = (n_relevant > 0) & (n_relevant < n_labels)
    per_label_loss = ((n_labels - _rank_inverse(preds)) * relevant).to(torch.float32)
    correction = 0.5 * n_relevant * (n_relevant + 1)
    denom = n_relevant * (n_labels - n_relevant)
    loss = (per_label_loss.sum(1) - correction) / torch.clamp(denom, min=1)
    return torch.where(valid, loss, 0.0)


def _label_ranking_loss_update(
    preds: torch.Tensor, target: torch.Tensor, sample_weight: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, int, Optional[torch.Tensor]]:
    preds, target, sample_weight = _ranking_inputs(preds, target, sample_weight)
    return _weighted_sum(_lrl_per_sample(preds, target), sample_weight)


_label_ranking_loss_compute = _ranking_compute


def label_ranking_loss(preds: torch.Tensor, target: torch.Tensor, sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Average share of (relevant, irrelevant) label pairs ordered wrong, on the device of the inputs.

    Example:
        >>> import torch
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.35]])
        >>> target = torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]])
        >>> round(float(label_ranking_loss(preds, target)), 6)
        0.0
    """
    loss, n, sample_weight = _label_ranking_loss_update(preds, target, sample_weight)
    return _label_ranking_loss_compute(loss, n, sample_weight)
