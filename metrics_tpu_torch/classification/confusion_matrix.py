"""ConfusionMatrix module metric (counterpart of ``metrics_tpu/classification/confusion_matrix.py``)."""

from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _confusion_matrix_compute,
    _confusion_matrix_update,
)
from metrics_tpu_torch.metric import Metric


class ConfusionMatrix(Metric):
    """Streaming (C, C) int32 confusion counts.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ConfusionMatrix
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> metric = ConfusionMatrix(num_classes=2, device='cpu')
        >>> metric.update(preds, target)
        >>> metric.compute()
        tensor([[2, 0],
                [1, 1]], dtype=torch.int32)
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False
    stackable = True  # fixed (num_classes, num_classes) confmat sum state

    def __init__(
        self,
        num_classes: int,
        normalize: Optional[str] = None,
        threshold: float = 0.5,
        multilabel: bool = False,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.normalize = normalize
        self.threshold = threshold
        self.multilabel = multilabel
        self.validate_args = validate_args
        allowed_normalize = ("true", "pred", "all", "none", None)
        if normalize not in allowed_normalize:
            raise ValueError(f"Argument average needs to one of the following: {allowed_normalize}")
        shape = (num_classes, 2, 2) if multilabel else (num_classes, num_classes)
        self.add_state("confmat", default=torch.zeros(shape, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        confmat = _confusion_matrix_update(
            preds, target, self.num_classes, self.threshold, self.multilabel, self.validate_args
        )
        self.confmat = self.confmat + confmat

    def compute(self) -> torch.Tensor:
        return _confusion_matrix_compute(self.confmat, self.normalize)
