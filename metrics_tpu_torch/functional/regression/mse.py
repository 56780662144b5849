"""Mean squared error (counterpart of ``metrics_tpu/functional/regression/mse.py``)."""

from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _as_tensor, _check_same_shape
from metrics_tpu_torch.utils.compute import _count, _sqrt


def _mean_squared_error_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold one batch into (float32 sum of squared errors, int32 observation count)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    _check_same_shape(preds, target)
    diff = preds.to(torch.float32) - target.to(torch.float32)
    return (diff * diff).sum(), _count(target.numel(), target.device)


def _mean_squared_error_compute(sum_squared_error: torch.Tensor, n_obs: torch.Tensor, squared: bool = True) -> torch.Tensor:
    out = sum_squared_error / n_obs
    return out if squared else _sqrt(out)


def mean_squared_error(preds: torch.Tensor, target: torch.Tensor, squared: bool = True) -> torch.Tensor:
    """MSE (or RMSE when ``squared=False``), on the device of the inputs.

    Example:
        >>> import torch
        >>> target = torch.tensor([2.5, 5.0, 4.0, 8.0])
        >>> preds = torch.tensor([3.0, 5.0, 2.5, 7.0])
        >>> float(mean_squared_error(preds, target))
        0.875
    """
    sum_squared_error, n_obs = _mean_squared_error_update(preds, target)
    return _mean_squared_error_compute(sum_squared_error, n_obs, squared=squared)
