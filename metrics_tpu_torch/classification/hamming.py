"""HammingDistance module metric (counterpart of ``metrics_tpu/classification/hamming.py``)."""

from typing import Any

import torch

from metrics_tpu_torch.functional.classification.hamming import (
    _hamming_distance_compute,
    _hamming_distance_update,
)
from metrics_tpu_torch.metric import Metric


class HammingDistance(Metric):
    """The share of labels predicted wrong (lower is better).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import HammingDistance
        >>> target = torch.tensor([[0, 1], [1, 1]])
        >>> preds = torch.tensor([[0, 1], [0, 1]])
        >>> metric = HammingDistance(device='cpu')
        >>> metric.update(preds, target)
        >>> float(metric.compute())
        0.25
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    stackable = True  # scalar sum states only; per-stream stacking is exact

    def __init__(self, threshold: float = 0.5, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.threshold = threshold
        self.validate_args = validate_args
        self.add_state("correct", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        correct, total = _hamming_distance_update(preds, target, self.threshold, validate_args=self.validate_args)
        self.correct = self.correct + correct
        self.total = self.total + total

    def compute(self) -> torch.Tensor:
        return _hamming_distance_compute(self.correct, self.total)
