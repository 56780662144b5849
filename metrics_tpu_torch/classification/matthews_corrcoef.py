"""MatthewsCorrCoef module metric (counterpart of ``metrics_tpu/classification/matthews_corrcoef.py``)."""

from typing import Any

import torch

from metrics_tpu_torch.functional.classification.matthews_corrcoef import (
    _matthews_corrcoef_compute,
    _matthews_corrcoef_update,
)
from metrics_tpu_torch.metric import Metric


class MatthewsCorrCoef(Metric):
    """Matthews correlation coefficient over a streamed ``(C, C)`` int32 confusion matrix.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MatthewsCorrCoef
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> metric = MatthewsCorrCoef(num_classes=2, device='cpu')
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 6)
        0.57735
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    stackable = True  # fixed (num_classes, num_classes) confmat sum state

    def __init__(self, num_classes: int, threshold: float = 0.5, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.threshold = threshold
        self.validate_args = validate_args
        self.add_state(
            "confmat", default=torch.zeros((num_classes, num_classes), dtype=torch.int32), dist_reduce_fx="sum"
        )

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        confmat = _matthews_corrcoef_update(preds, target, self.num_classes, self.threshold, validate_args=self.validate_args)
        self.confmat = self.confmat + confmat

    def compute(self) -> torch.Tensor:
        return _matthews_corrcoef_compute(self.confmat)
