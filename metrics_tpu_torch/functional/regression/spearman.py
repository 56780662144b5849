"""Spearman rank correlation (counterpart of ``metrics_tpu/functional/regression/spearman.py``).

Ranking is one sort and two ``searchsorted`` calls: the average rank of a
value ``v`` is ``#(x < v) + (#(x == v) + 1) / 2``.  The search runs on the
integer keys of ``precision_recall_curve._sort_keys`` (``-0.0`` equal to
``+0.0``, every NaN equal to the others and above ``+inf``), the order
``jnp.sort`` and ``jnp.searchsorted`` use.  ``torch.searchsorted`` on floats
has no defined place for a NaN, and with NaNs in the sorted array it
misplaces finite values too.
"""

from typing import Tuple

import torch

from metrics_tpu_torch.functional.classification.precision_recall_curve import _sort_keys
from metrics_tpu_torch.utils.checks import _as_tensor, _check_same_shape
from metrics_tpu_torch.utils.compute import _mean, _sqrt


def _rank_data(data: torch.Tensor) -> torch.Tensor:
    """float32 fractional ranks, 1-based (ties get their average rank).

    Ranks are exact below 2**24 values; past that the float32 cast rounds
    them, as it does in the JAX package.
    """
    keys = _sort_keys(data.reshape(-1))
    sorted_keys = torch.sort(keys).values
    lower = torch.searchsorted(sorted_keys, keys, side="left")
    upper = torch.searchsorted(sorted_keys, keys, side="right")
    return lower.to(torch.float32) + (upper - lower + 1).to(torch.float32) / 2.0


def _spearman_corrcoef_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check the batch (floats, equal shapes, 1-D once squeezed) and return it 1-D."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if not (preds.is_floating_point() and target.is_floating_point()):
        raise TypeError(f"Expected preds and target to be floating, got {preds.dtype} and {target.dtype}")
    _check_same_shape(preds, target)
    preds, target = preds.squeeze(), target.squeeze()
    if preds.ndim > 1 or target.ndim > 1:
        raise ValueError("Expected both predictions and target to be 1 dimensional tensors.")
    return torch.atleast_1d(preds), torch.atleast_1d(target)


def _spearman_corrcoef_compute(preds: torch.Tensor, target: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    preds = _rank_data(preds)
    target = _rank_data(target)
    preds_diff = preds - _mean(preds)
    target_diff = target - _mean(target)
    cov = _mean(preds_diff * target_diff)
    preds_std = _sqrt(_mean(preds_diff * preds_diff))
    target_std = _sqrt(_mean(target_diff * target_diff))
    corrcoef = cov / (preds_std * target_std + eps)
    return corrcoef.clamp(-1.0, 1.0)


def spearman_corrcoef(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Spearman correlation: pearson on fractional ranks, on the device of the inputs.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0, 4.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0, 1.0])
        >>> round(float(spearman_corrcoef(preds, target)), 4)
        0.7
    """
    preds, target = _spearman_corrcoef_update(preds, target)
    return _spearman_corrcoef_compute(preds, target)
