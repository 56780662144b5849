"""F-beta / F1 functionals (counterpart of ``metrics_tpu/functional/classification/f_beta.py``)."""

from typing import Optional

import torch

from metrics_tpu_torch.functional.classification.precision_recall import _check_avg_arg
from metrics_tpu_torch.functional.classification.stat_scores import (
    _reduce_stat_scores,
    _stat_scores_update,
)
from metrics_tpu_torch.utils.compute import _safe_divide
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod


def _fbeta_compute(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    beta: float,
    ignore_index: Optional[int],
    average: Optional[str],
    mdmc_average: Optional[str],
) -> torch.Tensor:
    if average == AverageMethod.MICRO and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        mask = tp >= 0
        zero = torch.zeros_like(tp)
        tp_s = torch.sum(torch.where(mask, tp, zero)).to(torch.float32)
        fp_s = torch.sum(torch.where(mask, fp, zero)).to(torch.float32)
        fn_s = torch.sum(torch.where(mask, fn, zero)).to(torch.float32)
        precision = _safe_divide(tp_s, tp_s + fp_s)
        recall = _safe_divide(tp_s, tp_s + fn_s)
    else:
        precision = _safe_divide(tp.to(torch.float32), (tp + fp).to(torch.float32))
        recall = _safe_divide(tp.to(torch.float32), (tp + fn).to(torch.float32))

    num = (1 + beta**2) * precision * recall
    denom = beta**2 * precision + recall
    denom = torch.where(denom == 0.0, 1.0, denom)  # avoid division by 0

    # classes absent from preds AND target are meaningless → sentinel them
    if average in (AverageMethod.NONE, None) and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        meaningless = ((tp | fn) | fp) == 0
        if ignore_index is not None:
            meaningless = meaningless | (torch.arange(tp.shape[-1], device=tp.device) == ignore_index)
        num = torch.where(meaningless, -1.0, num)
        denom = torch.where(meaningless, -1.0, denom)
    elif ignore_index is not None:
        if average not in (AverageMethod.MICRO, AverageMethod.SAMPLES):
            idx = torch.arange(num.shape[-1], device=num.device) == ignore_index
            num = torch.where(idx, -1.0, num)
            denom = torch.where(idx, -1.0, denom)

    if average == AverageMethod.MACRO and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        cond = ((tp + fp + fn) == 0) | ((tp + fp + fn) == -3)
        denom = torch.where(cond, -1.0, denom)

    return _reduce_stat_scores(
        numerator=num,
        denominator=denom,
        weights=None if average != AverageMethod.WEIGHTED else (tp + fn),
        average=average,
        mdmc_average=mdmc_average,
    )


def fbeta_score(
    preds: torch.Tensor,
    target: torch.Tensor,
    beta: float = 1.0,
    average: str = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    _check_avg_arg(average, mdmc_average, num_classes, ignore_index)
    reduce = "macro" if average in ("weighted", "none", None) else average
    tp, fp, tn, fn = _stat_scores_update(
        preds, target, reduce=reduce, mdmc_reduce=mdmc_average, threshold=threshold,
        num_classes=num_classes, top_k=top_k, multiclass=multiclass,
        ignore_index=ignore_index, validate_args=validate_args,
    )
    return _fbeta_compute(tp, fp, tn, fn, beta, ignore_index, average, mdmc_average)


def f1_score(
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
    """F1 score, on the device of the inputs.

    Example:
        >>> import torch
        >>> target = torch.tensor([0, 1, 2, 0, 1, 2])
        >>> preds = torch.tensor([0, 2, 1, 0, 0, 1])
        >>> round(float(f1_score(preds, target, num_classes=3)), 6)
        0.333333
    """
    return fbeta_score(
        preds, target, 1.0, average, mdmc_average, ignore_index, num_classes,
        threshold, top_k, multiclass, validate_args,
    )
