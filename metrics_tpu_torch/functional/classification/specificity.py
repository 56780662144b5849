"""Specificity functional (counterpart of ``metrics_tpu/functional/classification/specificity.py``)."""

from typing import Optional

import torch

from metrics_tpu_torch.functional.classification.precision_recall import _check_avg_arg
from metrics_tpu_torch.functional.classification.stat_scores import (
    _reduce_stat_scores,
    _stat_scores_update,
)
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod


def _specificity_compute(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
) -> torch.Tensor:
    numerator = tn
    denominator = tn + fp
    if average in (AverageMethod.NONE, None) and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        meaningless = ((tp | fn) | fp) == 0
        numerator = torch.where(meaningless, -1, numerator)
        denominator = torch.where(meaningless, -1, denominator)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else (tn + fp),
        average=average,
        mdmc_average=mdmc_average,
    )


def specificity(
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
    """Specificity, tn / (tn + fp), on the device of the inputs.

    Example:
        >>> import torch
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> round(float(specificity(preds, target, average='macro', num_classes=3)), 6)
        0.611111
    """
    _check_avg_arg(average, mdmc_average, num_classes, ignore_index)
    reduce = "macro" if average in ("weighted", "none", None) else average
    tp, fp, tn, fn = _stat_scores_update(
        preds, target, reduce=reduce, mdmc_reduce=mdmc_average, threshold=threshold,
        num_classes=num_classes, top_k=top_k, multiclass=multiclass,
        ignore_index=ignore_index, validate_args=validate_args,
    )
    return _specificity_compute(tp, fp, tn, fn, average, mdmc_average)
