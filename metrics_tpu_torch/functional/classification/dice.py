"""Dice score functional (counterpart of ``metrics_tpu/functional/classification/dice.py``)."""

import math
from typing import Optional

import torch

from metrics_tpu_torch.functional.classification.precision_recall import _check_avg_arg
from metrics_tpu_torch.functional.classification.stat_scores import (
    _reduce_stat_scores,
    _stat_scores_update,
)
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _dice_compute(
    tp: torch.Tensor,
    fp: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
    zero_division: int = 0,
) -> torch.Tensor:
    numerator = 2 * tp
    denominator = 2 * tp + fp + fn
    if average == AverageMethod.MACRO and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        cond = (tp + fp + fn) == 0
        denominator = torch.where(cond, -1, denominator)
    if average in (AverageMethod.NONE, None) and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        meaningless = ((tp | fn) | fp) == 0
        numerator = torch.where(meaningless, -1, numerator)
        denominator = torch.where(meaningless, -1, denominator)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else (tp + fn),
        average=average,
        mdmc_average=mdmc_average,
        zero_division=zero_division,
    )


def dice(
    preds: torch.Tensor,
    target: torch.Tensor,
    zero_division: int = 0,
    average: str = "micro",
    mdmc_average: Optional[str] = "global",
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Dice, 2 tp / (2 tp + fp + fn), on the device of the inputs.

    Example:
        >>> import torch
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> float(dice(preds, target, average='micro'))
        0.25
    """
    _check_avg_arg(average, mdmc_average, num_classes, ignore_index)
    reduce = "macro" if average in ("weighted", "none", None) else average
    tp, fp, _, fn = _stat_scores_update(
        preds, target, reduce=reduce, mdmc_reduce=mdmc_average, threshold=threshold,
        num_classes=num_classes, top_k=top_k, multiclass=multiclass,
        ignore_index=ignore_index, validate_args=validate_args,
    )
    return _dice_compute(tp, fp, fn, average, mdmc_average, zero_division)


def dice_score(
    preds: torch.Tensor,
    target: torch.Tensor,
    bg: bool = False,
    nan_score: float = 0.0,
    no_fg_score: float = 0.0,
    reduction: str = "elementwise_mean",
) -> torch.Tensor:
    """Deprecated alias for :func:`dice`: the macro dice over classes, without
    the background class 0 unless ``bg``.

    Example:
        >>> import torch
        >>> pred = torch.tensor([[0.85, 0.05, 0.05, 0.05], [0.05, 0.85, 0.05, 0.05],
        ...                      [0.05, 0.05, 0.85, 0.05], [0.05, 0.05, 0.05, 0.85]])
        >>> target = torch.tensor([0, 1, 3, 2])
        >>> float(dice_score(pred, target))
        0.3333333432674408
    """
    rank_zero_warn("The `dice_score` function is deprecated. Use the `dice` function instead.", DeprecationWarning)
    num_classes = preds.shape[1]
    if no_fg_score != 0.0:
        rank_zero_warn("Deprecated parameter. Switched to default `no_fg_score` = 0.0.")
    if reduction != "elementwise_mean":
        rank_zero_warn("Deprecated parameter. Switched to default `reduction` = 'elementwise_mean'.")
    if not math.isfinite(nan_score):
        nan_score = 0.0
        rank_zero_warn("Deprecated parameter. Non-finite `nan_score` switched to 0.")
    zero_division = math.floor(nan_score)
    if zero_division != nan_score:
        rank_zero_warn(f"Deprecated parameter. `nan_score` converted to integer {zero_division}.")
    ignore_index = None if bg else 0
    return dice(preds, target, ignore_index=ignore_index, average="macro", num_classes=num_classes,
                zero_division=zero_division)
