"""Accuracy functional (counterpart of ``metrics_tpu/functional/classification/accuracy.py``).

Absent classes under ``average="macro"`` get the ``-1`` denominator sentinel
that :func:`_reduce_stat_scores` masks out.
"""

from typing import Optional, Tuple

import torch

from metrics_tpu_torch.functional.classification.stat_scores import (
    _reduce_stat_scores,
    _stat_scores_update,
)
from metrics_tpu_torch.obs import core as _obs
from metrics_tpu_torch.utils.checks import (
    _as_tensor,
    _check_classification_inputs,
    _classify_case,
    _input_format_classification,
    _input_squeeze,
)
from metrics_tpu_torch.utils.enums import AverageMethod, DataType, MDMCAverageMethod


def _check_subset_validity(mode: DataType) -> bool:
    return mode in (DataType.MULTILABEL, DataType.MULTIDIM_MULTICLASS)


@_obs.spanned_function("validation.check")
def _mode(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float,
    top_k: Optional[int],
    num_classes: Optional[int],
    multiclass: Optional[bool],
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> DataType:
    """Input-case detection (with validation when ``validate_args``)."""
    preds, target = _input_squeeze(_as_tensor(preds), _as_tensor(target))
    if validate_args:
        _check_classification_inputs(
            preds,
            target,
            threshold=threshold,
            num_classes=num_classes,
            multiclass=multiclass,
            top_k=top_k,
            ignore_index=ignore_index,
        )
    return _classify_case(preds, target, multiclass)


def _accuracy_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    reduce: Optional[str],
    mdmc_reduce: Optional[str],
    threshold: float,
    num_classes: Optional[int],
    top_k: Optional[int],
    multiclass: Optional[bool],
    ignore_index: Optional[int],
    mode: DataType,
    validate_args: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    if mode == DataType.MULTILABEL and top_k:
        raise ValueError("You can not use the `top_k` parameter to calculate accuracy for multi-label inputs.")
    preds, target = _input_squeeze(_as_tensor(preds), _as_tensor(target))
    return _stat_scores_update(
        preds,
        target,
        reduce=reduce,
        mdmc_reduce=mdmc_reduce,
        threshold=threshold,
        num_classes=num_classes,
        top_k=top_k,
        multiclass=multiclass,
        ignore_index=ignore_index,
        mode=mode,
        validate_args=validate_args,
    )


def _accuracy_compute(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
    mode: DataType,
) -> torch.Tensor:
    simple_average = (AverageMethod.MICRO, AverageMethod.SAMPLES)
    if (mode == DataType.BINARY and average in simple_average) or mode == DataType.MULTILABEL:
        numerator = tp + tn
        denominator = tp + tn + fp + fn
    else:
        numerator = tp
        denominator = tp + fn

    if mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        cond = (tp + fp + fn) == 0
        if average == AverageMethod.MACRO:
            # sentinel-mask absent classes instead of boolean-dropping them
            denominator = torch.where(cond, -1, denominator)
        if average in (AverageMethod.NONE, None):
            meaningless = ((tp | fn) | fp) == 0
            numerator = torch.where(meaningless, -1, numerator)
            denominator = torch.where(meaningless, -1, denominator)

    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else (tp + fn),
        average=average,
        mdmc_average=mdmc_average,
    )


def _subset_accuracy_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float,
    top_k: Optional[int],
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    preds, target = _input_squeeze(_as_tensor(preds), _as_tensor(target))
    preds, target, mode = _input_format_classification(
        preds, target, threshold=threshold, top_k=top_k, ignore_index=ignore_index, validate_args=validate_args
    )
    if mode == DataType.MULTILABEL and top_k:
        raise ValueError("You can not use the `top_k` parameter to calculate accuracy for multi-label inputs.")

    device = preds.device
    if mode == DataType.MULTILABEL:
        correct = torch.sum(torch.all(preds == target, dim=1))
        total = torch.tensor(target.shape[0], device=device)
    elif mode == DataType.MULTICLASS:
        correct = torch.sum(preds * target)
        total = torch.sum(target)
    elif mode == DataType.MULTIDIM_MULTICLASS:
        sample_correct = torch.sum(preds * target, dim=(1, 2))
        correct = torch.sum(sample_correct == target.shape[2])
        total = torch.tensor(target.shape[0], device=device)
    else:
        correct = total = torch.tensor(0, device=device)
    return correct.to(torch.int32), total.to(torch.int32)


def _subset_accuracy_compute(correct: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    return correct.to(torch.float32) / total


def accuracy(
    preds: torch.Tensor,
    target: torch.Tensor,
    average: str = "micro",
    mdmc_average: Optional[str] = "global",
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    subset_accuracy: bool = False,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Accuracy, on the device of the inputs.

    Example:
        >>> import torch
        >>> target = torch.tensor([0, 1, 2, 3])
        >>> preds = torch.tensor([0, 2, 1, 3])
        >>> float(accuracy(preds, target, num_classes=4))
        0.5
    """
    allowed_average = ("micro", "macro", "weighted", "samples", "none", None)
    if average not in allowed_average:
        raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")

    if average in ("macro", "weighted", "none", None) and (not num_classes or num_classes < 1):
        raise ValueError(f"When you set `average` as {average}, you have to provide the number of classes.")

    allowed_mdmc_average = (None, "samplewise", "global")
    if mdmc_average not in allowed_mdmc_average:
        raise ValueError(f"The `mdmc_average` has to be one of {allowed_mdmc_average}, got {mdmc_average}.")

    if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")

    preds, target = _as_tensor(preds), _as_tensor(target)
    if top_k is not None and (not isinstance(top_k, int) or top_k <= 0):
        raise ValueError(f"The `top_k` should be an integer larger than 0, got {top_k}")

    mode = _mode(preds, target, threshold, top_k, num_classes, multiclass, ignore_index, validate_args)
    reduce = "macro" if average in ("weighted", "none", None) else average

    if subset_accuracy and _check_subset_validity(mode):
        correct, total = _subset_accuracy_update(
            preds, target, threshold, top_k, ignore_index, validate_args
        )
        return _subset_accuracy_compute(correct, total)
    tp, fp, tn, fn = _accuracy_update(
        preds, target, reduce, mdmc_average, threshold, num_classes, top_k, multiclass,
        ignore_index, mode, validate_args,
    )
    return _accuracy_compute(tp, fp, tn, fn, average, mdmc_average, mode)
