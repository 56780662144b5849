"""Average precision functional
(counterpart of ``metrics_tpu/functional/classification/average_precision.py``).

Every class's precision-recall curve comes out of one batched sweep and
every class's step integral out of one masked sum over the rows, on the
device of the inputs.
"""

from typing import List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    _class_rows,
    _pr_rows,
    _precision_recall_curve_update,
    _sample_weights,
)
from metrics_tpu_torch.utils.data import _bincount
from metrics_tpu_torch.utils.prints import warn_once


def _average_precision_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
) -> Tuple[torch.Tensor, torch.Tensor, int, Optional[int]]:
    preds, target, num_classes, pos_label = _precision_recall_curve_update(preds, target, num_classes, pos_label)
    if average == "micro" and preds.ndim != target.ndim:
        raise ValueError("Cannot use `micro` average with multi-class input")
    return preds, target, num_classes, pos_label


def _step_integrals(precision: torch.Tensor, recall: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """``-sum((r[i+1] - r[i]) * p[i])`` over each row's first ``points[k]`` entries (float32)."""
    terms = (recall[:, 1:] - recall[:, :-1]) * precision[:, :-1]
    valid = torch.arange(terms.shape[1], device=terms.device) < (points[:, None] - 1)
    return -torch.where(valid, terms, 0).sum(1)


def _reduce_average_precision(
    res: torch.Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    weights: Optional[torch.Tensor] = None,
) -> Union[List[torch.Tensor], torch.Tensor]:
    """The per-class scores ``res (C,)`` averaged as the JAX package averages them."""
    if num_classes == 1:
        return res[0]
    if average in ("macro", "weighted"):
        if average == "macro" or (weights is not None and bool(torch.isclose(weights.sum(), torch.zeros(())))):
            has_nan = bool(torch.isnan(res).any())
            if has_nan:
                warn_once(
                    "Average precision score for one or more classes was `nan`. Ignoring these classes in macro-average",
                    UserWarning,
                    key="average_precision.nan_classes",
                )
            return torch.nanmean(res) if has_nan else res.mean()
        weights = weights / weights.sum()
        return (res * weights).sum()
    if average in (None, "none"):
        return list(res)
    raise ValueError(f"Received an incompatible combinations of inputs to make reduction with average={average}")


def _average_precision_compute(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    sample_weights: Optional[Sequence] = None,
) -> Union[List[torch.Tensor], torch.Tensor]:
    if average == "micro" and preds.ndim == target.ndim:
        preds = preds.reshape(-1)
        target = target.reshape(-1)
        num_classes = 1
    if average == "weighted":
        if preds.ndim == target.ndim and target.ndim > 1:
            weights = target.sum(0).to(torch.float32)
        else:
            weights = _bincount(target.to(torch.int32), num_classes).to(torch.float32)
    else:
        weights = None
    if num_classes == 1 and pos_label is None:
        pos_label = 1
    scores, positives = _class_rows(preds, target, num_classes, pos_label, num_classes == 1)
    precision, recall, _, points = _pr_rows(scores, positives, _sample_weights(sample_weights, preds.device))
    return _reduce_average_precision(_step_integrals(precision, recall, points), num_classes, average, weights)


def average_precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    sample_weights: Optional[Sequence] = None,
) -> Union[List[torch.Tensor], torch.Tensor]:
    """Area under the precision-recall step curve, on the device of the inputs.

    Example:
        >>> import torch
        >>> pred = torch.tensor([0.0, 1.0, 2.0, 3.0])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> float(average_precision(pred, target, pos_label=1))
        1.0
    """
    preds, target, num_classes, pos_label = _average_precision_update(preds, target, num_classes, pos_label, average)
    return _average_precision_compute(preds, target, num_classes, pos_label, average, sample_weights)
