"""error_relative_global_dimensionless_synthesis (counterpart of
``metrics_tpu/functional/image/ergas.py``)."""

from typing import Optional, Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _as_tensor, _check_same_shape
from metrics_tpu_torch.utils.compute import _mean, _sqrt
from metrics_tpu_torch.utils.data import reduce


def _ergas_check_inputs(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shape and type validation."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {preds.dtype} and target: {target.dtype}."
        )
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    return preds, target


def _ergas_per_image(preds: torch.Tensor, target: torch.Tensor, ratio: Union[int, float] = 4) -> torch.Tensor:
    """Per-image ERGAS, shape ``(B,)``."""
    b, c, h, w = preds.shape
    preds = preds.reshape(b, c, h * w)
    target = target.reshape(b, c, h * w)
    diff = preds - target
    sum_squared_error = torch.sum(diff * diff, dim=2)
    rmse_per_band = _sqrt(sum_squared_error / (h * w))
    mean_target = _mean(target, dim=2)
    return 100 * ratio * _sqrt(torch.sum((rmse_per_band / mean_target) ** 2, dim=1) / c)


def error_relative_global_dimensionless_synthesis(
    preds: torch.Tensor,
    target: torch.Tensor,
    ratio: Union[int, float] = 4,
    reduction: Optional[str] = "elementwise_mean",
) -> torch.Tensor:
    """ERGAS score, on the device of the inputs.

    Example:
        >>> import torch
        >>> preds = torch.rand((16, 1, 16, 16), generator=torch.Generator().manual_seed(42))
        >>> target = preds * 0.75
        >>> float(error_relative_global_dimensionless_synthesis(preds, target)) > 0
        True
    """
    preds, target = _ergas_check_inputs(preds, target)
    return reduce(_ergas_per_image(preds, target, ratio), reduction)
