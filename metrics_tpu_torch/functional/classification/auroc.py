"""AUROC functional (counterpart of ``metrics_tpu/functional/classification/auroc.py``).

Every class's ROC curve comes out of one batched sweep
(:func:`~metrics_tpu_torch.functional.classification.precision_recall_curve._roc_rows`)
and every area out of one masked trapezoid over the rows, on the device of
the inputs: no per-class loop and no copy of the scores to the host.
"""

import warnings
from typing import Optional, Sequence, Tuple

import torch

from metrics_tpu_torch.functional.classification.auc import _trapezoid
from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    _class_rows,
    _roc_rows,
    _sample_weights,
)
from metrics_tpu_torch.functional.classification.roc import _roc_update
from metrics_tpu_torch.utils.checks import _checked_inputs
from metrics_tpu_torch.utils.data import _bincount, _x32
from metrics_tpu_torch.utils.enums import AverageMethod, DataType


def _auroc_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, DataType]:
    """The inputs with the class last and the extra dims flattened, and their input case.

    The case is decided as the JAX package decides it, without its canonical
    one-hot transform: for float scores that takes no device->host read.
    """
    preds, target = _x32(torch.as_tensor(preds)), _x32(torch.as_tensor(target))
    _, _, mode = _checked_inputs(preds, target, validate_args=False)
    if (mode == DataType.MULTIDIM_MULTICLASS and preds.is_floating_point()) or (
        mode == DataType.MULTILABEL and preds.ndim > 2
    ):
        n_classes = preds.shape[1]
        preds = torch.movedim(preds, 1, -1).reshape(-1, n_classes)
        target = target.reshape(-1) if mode == DataType.MULTIDIM_MULTICLASS else (
            torch.movedim(target, 1, -1).reshape(-1, n_classes)
        )
    return preds, target, mode


def _row_aucs(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    pos_label: Optional[int],
    sample_weights: Optional[Sequence],
    single: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each row's float32 area under its ROC curve, with the curves (fpr, tpr, points)."""
    scores, positives = _class_rows(preds, target, num_classes, pos_label, single)
    fpr, tpr, _, points = _roc_rows(scores, positives, _sample_weights(sample_weights, preds.device))
    segments = torch.arange(fpr.shape[1] - 1, device=fpr.device) < (points[:, None] - 1)
    return _trapezoid(tpr, fpr, segments), fpr, tpr, points


def _partial_auc(fpr: torch.Tensor, tpr: torch.Tensor, max_fpr: float) -> torch.Tensor:
    """The McClish-standardised area over ``[0, max_fpr]``, in float64, as float32."""
    fpr, tpr = fpr.to(torch.float64), tpr.to(torch.float64)
    stop = int(torch.searchsorted(fpr, torch.tensor([max_fpr], dtype=torch.float64, device=fpr.device), right=True))
    weight = (max_fpr - fpr[stop - 1]) / (fpr[stop] - fpr[stop - 1])
    interp_tpr = tpr[stop - 1] + weight * (tpr[stop] - tpr[stop - 1])
    tpr = torch.cat([tpr[:stop], interp_tpr[None]])
    fpr = torch.cat([fpr[:stop], fpr.new_tensor([max_fpr])])
    partial_auc = ((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2.0).sum()  # np.trapezoid
    min_area = 0.5 * max_fpr**2
    max_area = max_fpr
    return (0.5 * (1 + (partial_auc - min_area) / (max_area - min_area))).to(torch.float32)


def _auroc_compute(
    preds: torch.Tensor,
    target: torch.Tensor,
    mode: DataType,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    sample_weights: Optional[Sequence] = None,
) -> torch.Tensor:
    if mode == DataType.BINARY:
        num_classes = 1

    if max_fpr is not None:
        if not isinstance(max_fpr, float) or not 0 < max_fpr <= 1:
            raise ValueError(f"`max_fpr` should be a float in range (0, 1], got: {max_fpr}")
        if mode != DataType.BINARY:
            raise ValueError(
                "Partial AUC computation not available in multilabel/multiclass setting,"
                f" 'max_fpr' must be set to `None`, received `{max_fpr}`."
            )

    if mode == DataType.MULTILABEL:
        if average == AverageMethod.MICRO:
            preds, target, num_classes, pos_label = _roc_update(preds.reshape(-1), target.reshape(-1), 1, pos_label)
        elif not num_classes:
            raise ValueError("Detected input to be `multilabel` but you did not provide `num_classes` argument")
    else:
        if mode != DataType.BINARY:
            if num_classes is None:
                raise ValueError("Detected input to `multiclass` but you did not provide `num_classes` argument")
            if average == AverageMethod.WEIGHTED:
                observed = _bincount(target, num_classes) > 0
                if not bool(observed.all()):
                    # classes with zero observations are left out (their weight is 0)
                    for c in (~observed).nonzero().flatten().tolist():
                        warnings.warn(f"Class {c} had 0 observations, omitted from AUROC calculation", UserWarning)
                    preds = preds[:, observed]
                    target = (observed.cumsum(0) - 1)[target.long()]
                    num_classes = int(observed.sum())
                    if num_classes == 1:
                        raise ValueError("Found 1 non-empty class in `multiclass` AUROC calculation")
        preds, target, num_classes, pos_label = _roc_update(preds, target, num_classes, pos_label)
    single = num_classes == 1 and preds.ndim == 1

    aucs, fpr, tpr, points = _row_aucs(preds, target, num_classes, pos_label, sample_weights, single)

    if max_fpr is None or max_fpr == 1:
        if single:
            return aucs[0]
        if average == AverageMethod.NONE:
            return aucs
        if average == AverageMethod.MACRO:
            return aucs.mean()
        if average == AverageMethod.WEIGHTED:
            if mode == DataType.MULTILABEL:
                support = target.sum(0).to(torch.float32)
            else:
                support = _bincount(target.reshape(-1).to(torch.int32), num_classes).to(torch.float32)
            return (aucs * support / support.sum()).sum()
        allowed_average = ("none", "macro", "weighted")
        raise ValueError(
            f"Argument `average` expected to be one of the following: {allowed_average} but got {average}"
        )

    n = int(points[0])
    return _partial_auc(fpr[0, :n], tpr[0, :n], max_fpr)


def auroc(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    sample_weights: Optional[Sequence] = None,
) -> torch.Tensor:
    """Area under the ROC curve, on the device of the inputs.

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.13, 0.26, 0.08, 0.19, 0.34])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> float(auroc(preds, target, pos_label=1))
        0.5
    """
    preds, target, mode = _auroc_update(preds, target)
    return _auroc_compute(preds, target, mode, num_classes, pos_label, average, max_fpr, sample_weights)
