"""AUC, the trapezoidal area under any x/y curve
(counterpart of ``metrics_tpu/functional/classification/auc.py``)."""

from typing import Tuple

import torch

from metrics_tpu_torch.functional.classification.precision_recall_curve import _sort_keys
from metrics_tpu_torch.utils.data import _x32


def _auc_update(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x, y = _x32(torch.as_tensor(x)), _x32(torch.as_tensor(y))
    if x.ndim > 1:
        x = x.squeeze()
    if y.ndim > 1:
        y = y.squeeze()
    if x.ndim > 1 or y.ndim > 1 or x.shape != y.shape:
        raise ValueError(
            f"Expected both `x` and `y` to be 1d of the same size, got {tuple(x.shape)} and {tuple(y.shape)}"
        )
    return x, y


def _trapezoid(y: torch.Tensor, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``jnp.trapezoid(y, x)`` along the last axis over the segments where ``valid``
    (``(..., P - 1)``), in the inputs' floating dtype (float32 for integers)."""
    dtype = torch.promote_types(x.dtype, y.dtype)
    if not dtype.is_floating_point:
        dtype = torch.float32
    x, y = x.to(dtype), y.to(dtype)
    terms = (x[..., 1:] - x[..., :-1]) * (y[..., 1:] + y[..., :-1])
    return 0.5 * torch.where(valid, terms, 0).sum(-1)


def _auc_compute_without_check(x: torch.Tensor, y: torch.Tensor, direction: float) -> torch.Tensor:
    valid = torch.ones(x.shape[-1] - 1 if x.shape[-1] else 0, dtype=torch.bool, device=x.device)
    return _trapezoid(y, x, valid) * direction


def _auc_compute(x: torch.Tensor, y: torch.Tensor, reorder: bool = False) -> torch.Tensor:
    if reorder:
        order = torch.sort(_sort_keys(x), stable=True).indices
        x, y = x[order], y[order]
    dx = torch.diff(x)
    if bool((dx < 0).any()):
        if not bool((dx <= 0).all()):
            raise ValueError(
                "The `x` array is neither increasing or decreasing. Try setting the reorder argument to `True`."
            )
        return _auc_compute_without_check(x, y, -1.0)
    return _auc_compute_without_check(x, y, 1.0)


def auc(x: torch.Tensor, y: torch.Tensor, reorder: bool = False) -> torch.Tensor:
    """Area under the curve y(x) by the trapezoidal rule, on the device of the inputs.

    Example:
        >>> import torch
        >>> x = torch.tensor([0.0, 1.0, 2.0, 3.0])
        >>> y = torch.tensor([0.0, 1.0, 2.0, 2.0])
        >>> float(auc(x, y))
        4.0
    """
    x, y = _auc_update(x, y)
    return _auc_compute(x, y, reorder=reorder)
