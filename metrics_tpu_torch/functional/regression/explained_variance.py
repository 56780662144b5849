"""Explained variance (counterpart of ``metrics_tpu/functional/regression/explained_variance.py``)."""

from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _as_tensor, _check_same_shape
from metrics_tpu_torch.utils.compute import _mean

_ALLOWED_MULTIOUTPUT = ("raw_values", "uniform_average", "variance_weighted")


def _explained_variance_update(
    preds: torch.Tensor, target: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The float32 row count and the per-output sums of the error, its square, the target and its square."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    _check_same_shape(preds, target)
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    n_obs = torch.full((), preds.shape[0], dtype=torch.float32, device=preds.device)
    diff = target - preds
    return n_obs, diff.sum(0), (diff * diff).sum(0), target.sum(0), (target * target).sum(0)


def _explained_variance_compute(
    n_obs: torch.Tensor,
    sum_error: torch.Tensor,
    sum_squared_error: torch.Tensor,
    sum_target: torch.Tensor,
    sum_squared_target: torch.Tensor,
    multioutput: str = "uniform_average",
) -> torch.Tensor:
    diff_avg = sum_error / n_obs
    numerator = sum_squared_error / n_obs - diff_avg * diff_avg
    target_avg = sum_target / n_obs
    denominator = sum_squared_target / n_obs - target_avg * target_avg

    # division-by-zero policy, branch-free: the score is 1 where the numerator
    # is 0, 0 where only the denominator is 0, else 1 - numerator / denominator
    nonzero_numerator = numerator != 0
    nonzero_denominator = denominator != 0
    safe_den = torch.where(nonzero_denominator, denominator, torch.ones_like(denominator))
    output_scores = torch.where(
        nonzero_numerator & nonzero_denominator,
        1.0 - numerator / safe_den,
        torch.where(nonzero_numerator & ~nonzero_denominator, 0.0, 1.0),
    )
    if multioutput == "raw_values":
        return output_scores
    if multioutput == "uniform_average":
        return _mean(output_scores)
    if multioutput == "variance_weighted":
        return (denominator / denominator.sum() * output_scores).sum()
    raise ValueError(f"Argument `multioutput` must be one of {_ALLOWED_MULTIOUTPUT}, got {multioutput}")


def explained_variance(preds: torch.Tensor, target: torch.Tensor, multioutput: str = "uniform_average") -> torch.Tensor:
    """Explained variance regression score, on the device of the inputs.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(explained_variance(preds, target)), 6)
        0.957173
    """
    stats = _explained_variance_update(preds, target)
    return _explained_variance_compute(*stats, multioutput=multioutput)
