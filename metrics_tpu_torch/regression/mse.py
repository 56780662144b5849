"""MeanSquaredError module metric (counterpart of ``metrics_tpu/regression/mse.py``)."""

from typing import Any

import torch

from metrics_tpu_torch.functional.regression.mse import _mean_squared_error_compute, _mean_squared_error_update
from metrics_tpu_torch.metric import Metric


class MeanSquaredError(Metric):
    """Mean squared error (or its root, ``squared=False``) over the stream: a
    float32 sum and an int32 element count.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanSquaredError
        >>> metric = MeanSquaredError(device='cpu')
        >>> metric.update(torch.tensor([3.0, 5.0, 2.5, 7.0]), torch.tensor([2.5, 5.0, 4.0, 8.0]))
        >>> float(metric.compute())
        0.875
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    stackable = True  # scalar sum states only; per-stream stacking is exact

    def __init__(self, squared: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.squared = squared
        self.add_state("sum_squared_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        sum_squared_error, n_obs = _mean_squared_error_update(preds, target)
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.total = self.total + n_obs

    def compute(self) -> torch.Tensor:
        return _mean_squared_error_compute(self.sum_squared_error, self.total, squared=self.squared)
