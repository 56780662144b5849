"""Precision / Recall module metrics
(counterpart of ``metrics_tpu/classification/precision_recall.py``)."""

from typing import Any, Optional

import torch

from metrics_tpu_torch.classification.stat_scores import StatScores
from metrics_tpu_torch.functional.classification.precision_recall import (
    _precision_compute,
    _recall_compute,
)


class _PrecisionRecallBase(StatScores):
    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        num_classes: Optional[int] = None,
        threshold: float = 0.5,
        average: str = "micro",
        mdmc_average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        **kwargs: Any,
    ) -> None:
        allowed_average = ("micro", "macro", "weighted", "samples", "none", None)
        if average not in allowed_average:
            raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")
        if average in ("macro", "weighted", "none", None) and (not num_classes or num_classes < 1):
            raise ValueError(f"When you set `average` as {average}, you have to provide the number of classes.")
        super().__init__(
            reduce="macro" if average in ("weighted", "none", None) else average,
            mdmc_reduce=mdmc_average,
            threshold=threshold,
            top_k=top_k,
            num_classes=num_classes,
            multiclass=multiclass,
            ignore_index=ignore_index,
            **kwargs,
        )
        self.average = average


class Precision(_PrecisionRecallBase):
    """Precision = tp / (tp + fp).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Precision
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> metric = Precision(average='macro', num_classes=3, device='cpu')
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 6)
        0.166667
    """

    def compute(self) -> torch.Tensor:
        tp, fp, _, fn = self._get_final_stats()
        return _precision_compute(tp, fp, fn, self.average, self.mdmc_reduce)


class Recall(_PrecisionRecallBase):
    """Recall = tp / (tp + fn)."""

    def compute(self) -> torch.Tensor:
        tp, fp, _, fn = self._get_final_stats()
        return _recall_compute(tp, fp, fn, self.average, self.mdmc_reduce)
