"""KL divergence functional (counterpart of ``metrics_tpu/functional/classification/kl_divergence.py``)."""

from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utils.checks import _as_tensor, _check_same_shape
from metrics_tpu_torch.utils.compute import _safe_xlogy


def _kld_update(p: torch.Tensor, q: torch.Tensor, log_prob: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """KL(P||Q) of each row of the ``(N, D)`` inputs, and the int32 row count."""
    p, q = _as_tensor(p), _as_tensor(q)
    _check_same_shape(p, q)
    if p.ndim != 2 or q.ndim != 2:
        raise ValueError(f"Expected both p and q distribution to be 2D but got {p.ndim} and {q.ndim} respectively")

    total = torch.tensor(p.shape[0], dtype=torch.int32, device=p.device)
    if log_prob:
        measures = (torch.exp(p) * (p - q)).sum(-1)
    else:
        p = p / p.sum(-1, keepdim=True)
        q = q / q.sum(-1, keepdim=True)
        measures = _safe_xlogy(p, p / q).sum(-1)
    return measures, total


def _kld_compute(measures: torch.Tensor, total: torch.Tensor, reduction: Optional[str] = "mean") -> torch.Tensor:
    if reduction == "sum":
        return measures.sum()
    if reduction == "mean":
        return measures.sum() / total
    if reduction in ("none", None):
        return measures
    raise ValueError(f"Expected reduction to be one of ['mean', 'sum', 'none', None] but got {reduction}")


def kl_divergence(
    p: torch.Tensor, q: torch.Tensor, log_prob: bool = False, reduction: Optional[str] = "mean"
) -> torch.Tensor:
    """KL(P||Q) between distributions over the last dim, on the device of the inputs.

    Example:
        >>> import torch
        >>> p = torch.tensor([[0.36, 0.48, 0.16]])
        >>> q = torch.tensor([[1/3, 1/3, 1/3]])
        >>> round(float(kl_divergence(p, q)), 6)
        0.0853
    """
    measures, total = _kld_update(p, q, log_prob)
    return _kld_compute(measures, total, reduction)
