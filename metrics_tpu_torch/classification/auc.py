"""AUC module metric (counterpart of ``metrics_tpu/classification/auc.py``)."""

from typing import Any

import torch

from metrics_tpu_torch.functional.classification.auc import _auc_compute, _auc_update
from metrics_tpu_torch.metric import Metric


class AUC(Metric):
    """Area under the x/y curve the stream accumulates.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import AUC
        >>> metric = AUC(device='cpu')
        >>> metric.update(torch.tensor([0.0, 1.0]), torch.tensor([0.0, 1.0]))
        >>> metric.update(torch.tensor([2.0, 3.0]), torch.tensor([2.0, 2.0]))
        >>> float(metric.compute())
        4.0
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False
    stackable = False  # buffer states (x/y) grow with the stream

    def __init__(self, reorder: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.reorder = reorder
        self.add_buffer_state("x")
        self.add_buffer_state("y")

    def update(self, x: torch.Tensor, y: torch.Tensor) -> None:
        x, y = _auc_update(x, y)
        self._buffer_append("x", x)
        self._buffer_append("y", y)

    def compute(self) -> torch.Tensor:
        return _auc_compute(self.buffer_values("x"), self.buffer_values("y"), reorder=self.reorder)
