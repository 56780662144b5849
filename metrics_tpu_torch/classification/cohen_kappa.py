"""CohenKappa module metric (counterpart of ``metrics_tpu/classification/cohen_kappa.py``)."""

from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.classification.cohen_kappa import _cohen_kappa_compute, _cohen_kappa_update
from metrics_tpu_torch.metric import Metric


class CohenKappa(Metric):
    """Cohen's kappa inter-annotator agreement over a streamed ``(C, C)`` int32 confusion matrix.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CohenKappa
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0.35, 0.85, 0.48, 0.01])
        >>> metric = CohenKappa(num_classes=2, device='cpu')
        >>> metric.update(preds, target)
        >>> float(metric.compute())
        0.5
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        weights: Optional[str] = None,
        threshold: float = 0.5,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if weights not in (None, "linear", "quadratic"):
            raise ValueError("Argument weights needs to be None, 'linear' or 'quadratic'")
        self.num_classes = num_classes
        self.weights = weights
        self.threshold = threshold
        self.validate_args = validate_args
        self.add_state(
            "confmat", default=torch.zeros((num_classes, num_classes), dtype=torch.int32), dist_reduce_fx="sum"
        )

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        confmat = _cohen_kappa_update(preds, target, self.num_classes, self.threshold, validate_args=self.validate_args)
        self.confmat = self.confmat + confmat

    def compute(self) -> torch.Tensor:
        return _cohen_kappa_compute(self.confmat, self.weights)
