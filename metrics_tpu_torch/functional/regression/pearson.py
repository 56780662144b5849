"""Pearson correlation (counterpart of ``metrics_tpu/functional/regression/pearson.py``).

Streaming form: running means, centred second moments and the cross-moment,
folded per batch with the parallel-variance rule, in the JAX package's order
of float32 operations.
"""

from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _as_tensor, _check_same_shape
from metrics_tpu_torch.utils.compute import _mean, _sqrt


def _pearson_corrcoef_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    mean_x: torch.Tensor,
    mean_y: torch.Tensor,
    var_x: torch.Tensor,
    var_y: torch.Tensor,
    corr_xy: torch.Tensor,
    n_prior: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold a 1-D batch into the running pearson statistics."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    _check_same_shape(preds, target)
    preds, target = preds.squeeze(), target.squeeze()
    if preds.ndim > 1 or target.ndim > 1:
        raise ValueError("Expected both predictions and target to be 1 dimensional tensors.")
    preds = torch.atleast_1d(preds).to(torch.float32)
    target = torch.atleast_1d(target).to(torch.float32)

    n_obs = preds.numel()
    # the batch terms are one-element tensors, not 0-d ones: against a 0-d
    # float32 tensor torch keeps a bfloat16 state's dtype (``half()``), where
    # XLA widens it to float32
    mx_new = (n_prior * mean_x + _mean(preds).reshape(1) * n_obs) / (n_prior + n_obs)
    my_new = (n_prior * mean_y + _mean(target).reshape(1) * n_obs) / (n_prior + n_obs)
    n_new = n_prior + n_obs
    var_x = var_x + ((preds - mx_new) * (preds - mean_x)).sum(0, keepdim=True)
    var_y = var_y + ((target - my_new) * (target - mean_y)).sum(0, keepdim=True)
    corr_xy = corr_xy + ((preds - mx_new) * (target - mean_y)).sum(0, keepdim=True)
    return mx_new, my_new, var_x, var_y, corr_xy, n_new


def _pearson_corrcoef_compute(var_x: torch.Tensor, var_y: torch.Tensor, corr_xy: torch.Tensor, nb: torch.Tensor) -> torch.Tensor:
    var_x = var_x / (nb - 1)
    var_y = var_y / (nb - 1)
    corr_xy = corr_xy / (nb - 1)
    corrcoef = (corr_xy / _sqrt(var_x * var_y)).squeeze()
    return corrcoef.clamp(-1.0, 1.0)


def pearson_corrcoef(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Pearson correlation coefficient between two 1-D tensors, on the device of the inputs.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(pearson_corrcoef(preds, target)), 6)
        0.98487
    """
    preds = _as_tensor(preds)
    zero = torch.zeros((), dtype=torch.float32, device=preds.device)
    _, _, var_x, var_y, corr_xy, nb = _pearson_corrcoef_update(preds, target, zero, zero, zero, zero, zero, zero)
    return _pearson_corrcoef_compute(var_x, var_y, corr_xy, nb)
