"""Jaccard index (IoU) functional
(counterpart of ``metrics_tpu/functional/classification/jaccard.py``)."""

from typing import Optional

import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import _confusion_matrix_update

_jaccard_index_update = _confusion_matrix_update


def _drop(x: torch.Tensor, index: int) -> torch.Tensor:
    return torch.cat([x[:index], x[index + 1 :]])


def _jaccard_from_confmat(
    confmat: torch.Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    absent_score: float = 0.0,
) -> torch.Tensor:
    """float32 IoU from a ``(C, C)`` confusion matrix.  ``ignore_index`` zeroes its
    row and drops its class from the scores (and, for ``"weighted"``, the weights)."""
    allowed_average = ("micro", "macro", "weighted", "none", None)
    if average not in allowed_average:
        raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")
    if confmat.ndim != 2:
        # a multilabel (C, 2, 2) matrix has no diagonal, as jnp.diag has none for it
        raise ValueError(f"the Jaccard index needs a (C, C) confusion matrix, got shape {tuple(confmat.shape)}")
    confmat = confmat.to(torch.float32)
    ignored = ignore_index is not None and 0 <= ignore_index < num_classes
    if ignored:
        confmat = confmat.clone()
        confmat[ignore_index] = 0.0

    if average in ("none", None):
        intersection = torch.diag(confmat)
        union = confmat.sum(0) + confmat.sum(1) - intersection
        zero = union == 0
        scores = torch.where(zero, absent_score, intersection / torch.where(zero, 1.0, union))
        return _drop(scores, ignore_index) if ignored else scores

    if average == "macro":
        scores = _jaccard_from_confmat(confmat, num_classes, "none", ignore_index, absent_score)
        # the true quotient, as jnp.mean gives it (a CUDA mean multiplies by 1 / n)
        return scores.sum() / scores.new_tensor(scores.numel())

    if average == "micro":
        intersection = torch.diag(confmat).sum()
        union = (confmat.sum(1) + confmat.sum(0) - torch.diag(confmat)).sum()
        return intersection / union

    weights = confmat.sum(1) / confmat.sum()
    scores = _jaccard_from_confmat(confmat, num_classes, "none", ignore_index, absent_score)
    if ignored:
        weights = _drop(weights, ignore_index)
    return (weights * scores).sum()


def jaccard_index(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    absent_score: float = 0.0,
    threshold: float = 0.5,
    multilabel: bool = False,
    validate_args: bool = True,
) -> torch.Tensor:
    """Jaccard index, on the device of the inputs.

    Example:
        >>> import torch
        >>> target = torch.tensor([[0, 1, 0], [1, 1, 0]])
        >>> preds = torch.tensor([[0, 1, 0], [0, 1, 1]])
        >>> round(float(jaccard_index(preds, target, num_classes=2)), 6)
        0.5
    """
    confmat = _jaccard_index_update(preds, target, num_classes, threshold, multilabel, validate_args=validate_args)
    return _jaccard_from_confmat(confmat, num_classes, average, ignore_index, absent_score)
