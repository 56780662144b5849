"""R² score (counterpart of ``metrics_tpu/functional/regression/r2.py``)."""

from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _as_tensor, _check_same_shape
from metrics_tpu_torch.utils.compute import _count, _mean
from metrics_tpu_torch.utils.prints import warn_once


def _r2_score_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-output float32 sums of target, target² and residual², and the int32 row count."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    _check_same_shape(preds, target)
    if preds.ndim > 2:
        raise ValueError(
            "Expected both prediction and target to be 1D or 2D tensors,"
            f" but received tensors with dimension {tuple(preds.shape)}"
        )
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    residual = target - preds
    return (target * target).sum(0), target.sum(0), (residual * residual).sum(0), _count(target.shape[0], target.device)


def _r2_score_compute(
    sum_squared_obs: torch.Tensor,
    sum_obs: torch.Tensor,
    rss: torch.Tensor,
    n_obs: torch.Tensor,
    adjusted: int = 0,
    multioutput: str = "uniform_average",
) -> torch.Tensor:
    mean_obs = sum_obs / n_obs
    tss = sum_squared_obs - sum_obs * mean_obs
    raw_scores = 1 - rss / tss

    if multioutput == "raw_values":
        r2 = raw_scores
    elif multioutput == "uniform_average":
        r2 = _mean(raw_scores)
    elif multioutput == "variance_weighted":
        r2 = (tss / tss.sum() * raw_scores).sum()
    else:
        raise ValueError(
            "Argument `multioutput` must be either `raw_values`,"
            f" `uniform_average` or `variance_weighted`. Received {multioutput}."
        )

    if adjusted < 0 or not isinstance(adjusted, int):
        raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
    if adjusted != 0:
        if adjusted >= int(n_obs) - 1:
            # once per process: a streaming metric computes every step on every rank
            warn_once(
                "More independent regressions than data points in adjusted r2 score. "
                "Falls back to standard r2 score.",
                UserWarning,
                key="r2.adjusted_degenerate",
            )
        else:
            r2 = 1 - (1 - r2) * (n_obs - 1) / (n_obs - adjusted - 1)
    return r2


def r2_score(
    preds: torch.Tensor, target: torch.Tensor, adjusted: int = 0, multioutput: str = "uniform_average"
) -> torch.Tensor:
    """R² (coefficient of determination), optionally adjusted, on the device of the inputs.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(r2_score(preds, target)), 6)
        0.948608
    """
    sum_squared_obs, sum_obs, rss, n_obs = _r2_score_update(preds, target)
    return _r2_score_compute(sum_squared_obs, sum_obs, rss, n_obs, adjusted, multioutput)
