"""Precision / Recall functionals
(counterpart of ``metrics_tpu/functional/classification/precision_recall.py``)."""

from typing import Optional, Tuple

import torch

from metrics_tpu_torch.functional.classification.stat_scores import (
    _reduce_stat_scores,
    _stat_scores_update,
)
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod


def _check_avg_arg(average: Optional[str], mdmc_average: Optional[str], num_classes: Optional[int],
                   ignore_index: Optional[int]) -> None:
    allowed_average = ("micro", "macro", "weighted", "samples", "none", None)
    if average not in allowed_average:
        raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")
    allowed_mdmc_average = (None, "samplewise", "global")
    if mdmc_average not in allowed_mdmc_average:
        raise ValueError(f"The `mdmc_average` has to be one of {allowed_mdmc_average}, got {mdmc_average}.")
    if average in ("macro", "weighted", "none", None) and (not num_classes or num_classes < 1):
        raise ValueError(f"When you set `average` as {average}, you have to provide the number of classes.")
    if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")


def _mask_absent_classes(
    numerator: torch.Tensor,
    denominator: torch.Tensor,
    tp: torch.Tensor,
    fp: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sentinel-mask classes absent from preds AND target."""
    if mdmc_average == MDMCAverageMethod.SAMPLEWISE:
        return numerator, denominator
    if average == AverageMethod.MACRO:
        cond = (tp + fp + fn) == 0
        denominator = torch.where(cond, -1, denominator)
    if average in (AverageMethod.NONE, None):
        meaningless = ((tp | fn) | fp) == 0
        numerator = torch.where(meaningless, -1, numerator)
        denominator = torch.where(meaningless, -1, denominator)
    return numerator, denominator


def _precision_compute(
    tp: torch.Tensor,
    fp: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
) -> torch.Tensor:
    numerator, denominator = _mask_absent_classes(tp, tp + fp, tp, fp, fn, average, mdmc_average)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else (tp + fn),
        average=average,
        mdmc_average=mdmc_average,
    )


def _recall_compute(
    tp: torch.Tensor,
    fp: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
) -> torch.Tensor:
    numerator, denominator = _mask_absent_classes(tp, tp + fn, tp, fp, fn, average, mdmc_average)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else (tp + fn),
        average=average,
        mdmc_average=mdmc_average,
    )


def precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    average: str = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Precision, on the device of the inputs.

    Example:
        >>> import torch
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> round(float(precision(preds, target, average='macro', num_classes=3)), 6)
        0.166667
    """
    _check_avg_arg(average, mdmc_average, num_classes, ignore_index)
    reduce = "macro" if average in ("weighted", "none", None) else average
    tp, fp, _, fn = _stat_scores_update(
        preds, target, reduce=reduce, mdmc_reduce=mdmc_average, threshold=threshold,
        num_classes=num_classes, top_k=top_k, multiclass=multiclass,
        ignore_index=ignore_index, validate_args=validate_args,
    )
    return _precision_compute(tp, fp, fn, average, mdmc_average)


def recall(
    preds: torch.Tensor,
    target: torch.Tensor,
    average: str = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Recall, on the device of the inputs.

    Example:
        >>> import torch
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> round(float(recall(preds, target, average='macro', num_classes=3)), 6)
        0.333333
    """
    _check_avg_arg(average, mdmc_average, num_classes, ignore_index)
    reduce = "macro" if average in ("weighted", "none", None) else average
    tp, fp, _, fn = _stat_scores_update(
        preds, target, reduce=reduce, mdmc_reduce=mdmc_average, threshold=threshold,
        num_classes=num_classes, top_k=top_k, multiclass=multiclass,
        ignore_index=ignore_index, validate_args=validate_args,
    )
    return _recall_compute(tp, fp, fn, average, mdmc_average)



def precision_recall(
    preds: torch.Tensor,
    target: torch.Tensor,
    average: str = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
    validate_args: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precision and recall from one count of the stat scores, on the device of the inputs.

    Example:
        >>> import torch
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> p, r = precision_recall(preds, target, average='macro', num_classes=3)
        >>> round(float(p), 6), round(float(r), 6)
        (0.166667, 0.333333)
    """
    _check_avg_arg(average, mdmc_average, num_classes, ignore_index)
    reduce = "macro" if average in ("weighted", "none", None) else average
    tp, fp, _, fn = _stat_scores_update(
        preds, target, reduce=reduce, mdmc_reduce=mdmc_average, threshold=threshold,
        num_classes=num_classes, top_k=top_k, multiclass=multiclass,
        ignore_index=ignore_index, validate_args=validate_args,
    )
    return (
        _precision_compute(tp, fp, fn, average, mdmc_average),
        _recall_compute(tp, fp, fn, average, mdmc_average),
    )
