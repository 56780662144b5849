"""Weighted MAPE (counterpart of ``metrics_tpu/functional/regression/wmape.py``)."""

from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _as_tensor, _check_same_shape

_EPS = 1.17e-06


def _weighted_mean_absolute_percentage_error_update(
    preds: torch.Tensor, target: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 sums of |p - t| and of |t| (the scale)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    _check_same_shape(preds, target)
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    return (preds - target).abs().sum(), target.abs().sum()


def _weighted_mean_absolute_percentage_error_compute(
    sum_abs_error: torch.Tensor, sum_scale: torch.Tensor, epsilon: float = _EPS
) -> torch.Tensor:
    return sum_abs_error / sum_scale.clamp_min(epsilon)


def weighted_mean_absolute_percentage_error(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """WMAPE: sum(|p - t|) / sum(|t|), on the device of the inputs.

    Example:
        >>> import torch
        >>> target = torch.tensor([1.0, 10.0, 1e6])
        >>> preds = torch.tensor([0.9, 15.0, 1.2e6])
        >>> round(float(weighted_mean_absolute_percentage_error(preds, target)), 6)
        0.200003
    """
    sum_abs_error, sum_scale = _weighted_mean_absolute_percentage_error_update(preds, target)
    return _weighted_mean_absolute_percentage_error_compute(sum_abs_error, sum_scale)
