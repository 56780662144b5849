"""Input checks and the reduction shared by the pairwise functionals
(counterpart of ``metrics_tpu/functional/pairwise/helpers.py``)."""

from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utils.checks import _as_tensor
from metrics_tpu_torch.utils.compute import _mean


def _check_input(
    x: torch.Tensor, y: Optional[torch.Tensor] = None, zero_diagonal: Optional[bool] = None
) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """Check ``[N, d]`` and ``[M, d]`` inputs as float32; ``zero_diagonal`` defaults to True only when ``y`` is None."""
    x = _as_tensor(x)
    if x.ndim != 2:
        raise ValueError(f"Expected argument `x` to be a 2D tensor of shape `[N, d]` but got {tuple(x.shape)}")
    if y is not None:
        y = _as_tensor(y)
        if y.ndim != 2 or y.shape[1] != x.shape[1]:
            raise ValueError(
                "Expected argument `y` to be a 2D tensor of shape `[M, d]` where"
                " `d` should be same as the last dimension of `x`"
            )
        zero_diagonal = False if zero_diagonal is None else zero_diagonal
        return x.to(torch.float32), y.to(torch.float32), zero_diagonal
    x = x.to(torch.float32)
    return x, x, True if zero_diagonal is None else zero_diagonal


def _zero_diagonal(distmat: torch.Tensor, zero_diagonal: bool) -> torch.Tensor:
    """Zero the main diagonal (its first ``min(N, M)`` entries) of a matrix the caller owns."""
    if zero_diagonal:
        distmat.fill_diagonal_(0.0)
    return distmat


def _reduce_distance_matrix(distmat: torch.Tensor, reduction: Optional[str] = None) -> torch.Tensor:
    """Reduce an ``[N, M]`` matrix along its last dimension."""
    if reduction == "mean":
        return _mean(distmat, dim=-1)
    if reduction == "sum":
        return distmat.sum(-1)
    if reduction is None or reduction == "none":
        return distmat
    raise ValueError(f"Expected reduction to be one of `['mean', 'sum', None]` but got {reduction}")
