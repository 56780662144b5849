"""Mean absolute error (counterpart of ``metrics_tpu/functional/regression/mae.py``)."""

from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _as_tensor, _check_same_shape
from metrics_tpu_torch.utils.compute import _count


def _mean_absolute_error_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    preds, target = _as_tensor(preds), _as_tensor(target)
    _check_same_shape(preds, target)
    return (preds.to(torch.float32) - target.to(torch.float32)).abs().sum(), _count(target.numel(), target.device)


def _mean_absolute_error_compute(sum_abs_error: torch.Tensor, n_obs: torch.Tensor) -> torch.Tensor:
    return sum_abs_error / n_obs


def mean_absolute_error(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MAE over all elements, on the device of the inputs.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> float(mean_absolute_error(preds, target))
        0.5
    """
    sum_abs_error, n_obs = _mean_absolute_error_update(preds, target)
    return _mean_absolute_error_compute(sum_abs_error, n_obs)
