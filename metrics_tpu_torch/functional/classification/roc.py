"""ROC curve functional (counterpart of ``metrics_tpu/functional/classification/roc.py``)."""

from typing import List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    _class_rows,
    _precision_recall_curve_update,
    _roc_rows,
    _sample_weights,
    _split_rows,
)

_roc_update = _precision_recall_curve_update


def _roc_compute(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Union[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]]:
    single = num_classes == 1 and preds.ndim == 1
    if single and pos_label is None:
        pos_label = 1
    scores, positives = _class_rows(preds, target, num_classes, pos_label, single)
    fpr, tpr, thresholds, points = _roc_rows(scores, positives, _sample_weights(sample_weights, preds.device))
    if single:
        n = int(points[0])
        return fpr[0, :n], tpr[0, :n], thresholds[0, :n]
    return _split_rows(fpr, points), _split_rows(tpr, points), _split_rows(thresholds, points)


def roc(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
):
    """fpr, tpr, thresholds (per class for multi-class and multi-label), on the device of the inputs.

    Example:
        >>> import torch
        >>> pred = torch.tensor([0.0, 1.0, 2.0, 3.0])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> fpr, tpr, thresholds = roc(pred, target, pos_label=1)
        >>> tpr
        tensor([0.0000, 0.3333, 0.6667, 1.0000, 1.0000])
        >>> thresholds
        tensor([4., 3., 2., 1., 0.])
    """
    preds, target, num_classes, pos_label = _roc_update(preds, target, num_classes, pos_label)
    return _roc_compute(preds, target, num_classes, pos_label, sample_weights)
