"""WeightedMeanAbsolutePercentageError module metric (counterpart of ``metrics_tpu/regression/wmape.py``)."""

from typing import Any

import torch

from metrics_tpu_torch.functional.regression.wmape import (
    _weighted_mean_absolute_percentage_error_compute,
    _weighted_mean_absolute_percentage_error_update,
)
from metrics_tpu_torch.metric import Metric


class WeightedMeanAbsolutePercentageError(Metric):
    """Weighted MAPE over the stream: float32 sums of ``|p - t|`` and of ``|t|``
    (the epsilon applies in ``compute``).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import WeightedMeanAbsolutePercentageError
        >>> metric = WeightedMeanAbsolutePercentageError(device='cpu')
        >>> metric.update(torch.tensor([0.9, 15.0, 1.2e6]), torch.tensor([1.0, 10.0, 1e6]))
        >>> round(float(metric.compute()), 6)
        0.200003
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    stackable = True  # scalar sum states only; per-stream stacking is exact

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("sum_scale", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        sum_abs_error, sum_scale = _weighted_mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_error = self.sum_abs_error + sum_abs_error
        self.sum_scale = self.sum_scale + sum_scale

    def compute(self) -> torch.Tensor:
        return _weighted_mean_absolute_percentage_error_compute(self.sum_abs_error, self.sum_scale)
