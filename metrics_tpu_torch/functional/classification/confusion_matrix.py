"""Confusion matrix functional
(counterpart of ``metrics_tpu/functional/classification/confusion_matrix.py``)."""

from typing import Optional

import torch

from metrics_tpu_torch.functional.classification.stat_scores import _is_multidim_logits, _logits_counts
from metrics_tpu_torch.utils.checks import _canonical_format, _checked_inputs
from metrics_tpu_torch.utils.data import _bincount, _confusion_counts
from metrics_tpu_torch.utils.enums import DataType
from metrics_tpu_torch.utils.prints import warn_once


def _confusion_matrix_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    threshold: float = 0.5,
    multilabel: bool = False,
    validate_args: bool = True,
) -> torch.Tensor:
    """Unnormalized int32 confusion counts: ``(C, C)``, or ``(C, 2, 2)`` for multilabel.

    Multi-dimensional float logits ``(N, C, ...)`` with labels ``(N, ...)`` and
    ``num_classes == C`` are counted straight from the logits
    (:func:`fused_logits_counts`); every other input goes through the
    one-hots, their argmax and a ``bincount``.
    """
    # pass num_classes so out-of-range labels fail validation loudly instead
    # of being silently dropped by the fixed-length bincount
    checked_classes = None if multilabel else num_classes
    preds, target, mode = _checked_inputs(
        preds, target, threshold, num_classes=checked_classes, validate_args=validate_args
    )
    if not multilabel and _is_multidim_logits(preds, target, mode, "confmat") and num_classes == preds.shape[1]:
        return _logits_counts(preds, target, "confmat")
    preds, target, mode = _canonical_format(preds, target, mode, threshold, num_classes=checked_classes)
    if mode not in (DataType.BINARY, DataType.MULTILABEL):
        preds = torch.argmax(preds, dim=1)
        target = torch.argmax(target, dim=1)
    if multilabel:
        classes = torch.arange(num_classes, device=preds.device)
        unique_mapping = ((2 * target + preds) + 4 * classes).reshape(-1)
        bins = _bincount(unique_mapping, minlength=4 * num_classes)
        return bins.reshape(num_classes, 2, 2)
    return _confusion_counts(preds, target, num_classes)


def _confusion_matrix_compute(confmat: torch.Tensor, normalize: Optional[str] = None) -> torch.Tensor:
    allowed_normalize = ("true", "pred", "all", "none", None)
    if normalize not in allowed_normalize:
        raise ValueError(f"Argument average needs to one of the following: {allowed_normalize}")
    if normalize is not None and normalize != "none":
        confmat = confmat.to(torch.float32)
        if normalize == "true":
            confmat = confmat / torch.sum(confmat, dim=1, keepdim=True)
        elif normalize == "pred":
            confmat = confmat / torch.sum(confmat, dim=0, keepdim=True)
        elif normalize == "all":
            confmat = confmat / torch.sum(confmat)
        nan_mask = torch.isnan(confmat)
        if bool(torch.any(nan_mask)):
            warn_once(
                "nan values found in confusion matrix have been replaced with zeros.",
                key="confusion_matrix.nan_replaced",
            )
        confmat = torch.where(nan_mask, 0.0, confmat)
    return confmat


def confusion_matrix(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    normalize: Optional[str] = None,
    threshold: float = 0.5,
    multilabel: bool = False,
    validate_args: bool = True,
) -> torch.Tensor:
    """Confusion matrix, on the device of the inputs.

    Example:
        >>> import torch
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> confusion_matrix(preds, target, num_classes=2)
        tensor([[2, 0],
                [1, 1]], dtype=torch.int32)
    """
    confmat = _confusion_matrix_update(preds, target, num_classes, threshold, multilabel, validate_args)
    return _confusion_matrix_compute(confmat, normalize)
