"""TweedieDevianceScore module metric (counterpart of ``metrics_tpu/regression/tweedie_deviance.py``)."""

from typing import Any

import torch

from metrics_tpu_torch.functional.regression.tweedie_deviance import (
    _tweedie_deviance_score_compute,
    _tweedie_deviance_score_update,
)
from metrics_tpu_torch.metric import Metric


class TweedieDevianceScore(Metric):
    """Mean Tweedie deviance over the stream: a float32 sum and an int32 count.
    Each update checks ``power``'s domain on the device (one read per check).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import TweedieDevianceScore
        >>> metric = TweedieDevianceScore(power=2, device='cpu')
        >>> metric.update(torch.tensor([1.0, 2.0, 4.0]), torch.tensor([2.0, 2.0, 1.0]))
        >>> round(float(metric.compute()), 6)
        0.628765
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    stackable = True  # scalar sum states only; per-stream stacking is exact

    def __init__(self, power: float = 0.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if 0 < power < 1:
            raise ValueError(f"Deviance Score is not defined for power={power}.")
        self.power = power
        self.add_state("sum_deviance_score", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("num_observations", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, targets: torch.Tensor) -> None:
        sum_deviance_score, num_observations = _tweedie_deviance_score_update(preds, targets, self.power)
        self.sum_deviance_score = self.sum_deviance_score + sum_deviance_score
        self.num_observations = self.num_observations + num_observations

    def compute(self) -> torch.Tensor:
        return _tweedie_deviance_score_compute(self.sum_deviance_score, self.num_observations)
