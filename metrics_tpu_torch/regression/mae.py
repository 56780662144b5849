"""MeanAbsoluteError module metric (counterpart of ``metrics_tpu/regression/mae.py``)."""

from typing import Any

import torch

from metrics_tpu_torch.functional.regression.mae import _mean_absolute_error_compute, _mean_absolute_error_update
from metrics_tpu_torch.metric import Metric


class MeanAbsoluteError(Metric):
    """Mean absolute error over the stream: a float32 sum and an int32 element count.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanAbsoluteError
        >>> metric = MeanAbsoluteError(device='cpu')
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> float(metric.compute())
        0.5
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    stackable = True  # scalar sum states only; per-stream stacking is exact

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        sum_abs_error, n_obs = _mean_absolute_error_update(preds, target)
        self.sum_abs_error = self.sum_abs_error + sum_abs_error
        self.total = self.total + n_obs

    def compute(self) -> torch.Tensor:
        return _mean_absolute_error_compute(self.sum_abs_error, self.total)
