"""MeanSquaredLogError module metric (counterpart of ``metrics_tpu/regression/log_mse.py``)."""

from typing import Any

import torch

from metrics_tpu_torch.functional.regression.log_mse import _mean_squared_log_error_compute, _mean_squared_log_error_update
from metrics_tpu_torch.metric import Metric


class MeanSquaredLogError(Metric):
    """Mean squared log error over the stream: a float32 sum and an int32 element count.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanSquaredLogError
        >>> metric = MeanSquaredLogError(device='cpu')
        >>> metric.update(torch.tensor([3.0, 5.0, 2.5, 7.0]), torch.tensor([2.5, 5.0, 4.0, 8.0]))
        >>> round(float(metric.compute()), 6)
        0.03973
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    stackable = True  # scalar sum states only; per-stream stacking is exact

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_squared_log_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        sum_squared_log_error, n_obs = _mean_squared_log_error_update(preds, target)
        self.sum_squared_log_error = self.sum_squared_log_error + sum_squared_log_error
        self.total = self.total + n_obs

    def compute(self) -> torch.Tensor:
        return _mean_squared_log_error_compute(self.sum_squared_log_error, self.total)
