"""Symmetric MAPE (counterpart of ``metrics_tpu/functional/regression/symmetric_mape.py``)."""

from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _as_tensor, _check_same_shape
from metrics_tpu_torch.utils.compute import _count

_EPS = 1.17e-06


def _symmetric_mean_absolute_percentage_error_update(
    preds: torch.Tensor, target: torch.Tensor, epsilon: float = _EPS
) -> Tuple[torch.Tensor, torch.Tensor]:
    preds, target = _as_tensor(preds), _as_tensor(target)
    _check_same_shape(preds, target)
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    abs_per_error = 2 * (preds - target).abs() / (target.abs() + preds.abs()).clamp_min(epsilon)
    return abs_per_error.sum(), _count(target.numel(), target.device)


def _symmetric_mean_absolute_percentage_error_compute(sum_abs_per_error: torch.Tensor, n_obs: torch.Tensor) -> torch.Tensor:
    return sum_abs_per_error / n_obs


def symmetric_mean_absolute_percentage_error(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """sMAPE: mean(2|p - t| / max(|t| + |p|, eps)), on the device of the inputs.

    Example:
        >>> import torch
        >>> target = torch.tensor([1.0, 10.0, 1e6])
        >>> preds = torch.tensor([0.9, 15.0, 1.2e6])
        >>> round(float(symmetric_mean_absolute_percentage_error(preds, target)), 6)
        0.229027
    """
    sum_abs_per_error, n_obs = _symmetric_mean_absolute_percentage_error_update(preds, target)
    return _symmetric_mean_absolute_percentage_error_compute(sum_abs_per_error, n_obs)
