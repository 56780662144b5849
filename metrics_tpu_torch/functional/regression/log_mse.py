"""Mean squared log error (counterpart of ``metrics_tpu/functional/regression/log_mse.py``)."""

from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _as_tensor, _check_same_shape
from metrics_tpu_torch.utils.compute import _count


def _mean_squared_log_error_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    preds, target = _as_tensor(preds), _as_tensor(target)
    _check_same_shape(preds, target)
    diff = torch.log1p(preds.to(torch.float32)) - torch.log1p(target.to(torch.float32))
    return (diff * diff).sum(), _count(target.numel(), target.device)


def _mean_squared_log_error_compute(sum_squared_log_error: torch.Tensor, n_obs: torch.Tensor) -> torch.Tensor:
    return sum_squared_log_error / n_obs


def mean_squared_log_error(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MSLE: mean((log(1+p) - log(1+t))^2), on the device of the inputs.

    Example:
        >>> import torch
        >>> target = torch.tensor([2.5, 5.0, 4.0, 8.0])
        >>> preds = torch.tensor([3.0, 5.0, 2.5, 7.0])
        >>> round(float(mean_squared_log_error(preds, target)), 6)
        0.03973
    """
    sum_squared_log_error, n_obs = _mean_squared_log_error_update(preds, target)
    return _mean_squared_log_error_compute(sum_squared_log_error, n_obs)
