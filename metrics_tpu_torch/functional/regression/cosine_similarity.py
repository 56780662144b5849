"""Cosine similarity (counterpart of ``metrics_tpu/functional/regression/cosine_similarity.py``)."""

from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utils.checks import _as_tensor, _check_same_shape
from metrics_tpu_torch.utils.compute import _mean, _norm


def _cosine_similarity_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check the shapes; the rows themselves are the state (``(N, D)``, float32)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    _check_same_shape(preds, target)
    if preds.ndim != 2:
        raise ValueError(f"Expected input to cosine similarity to be 2D tensors, got {preds.ndim}D")
    return preds.to(torch.float32), target.to(torch.float32)


def _cosine_similarity_compute(preds: torch.Tensor, target: torch.Tensor, reduction: Optional[str] = "sum") -> torch.Tensor:
    dot_product = (preds * target).sum(-1)
    preds_norm = _norm(preds)
    target_norm = _norm(target)
    similarity = dot_product / (preds_norm * target_norm)
    if reduction == "sum":
        return similarity.sum()
    if reduction == "mean":
        return _mean(similarity)
    if reduction in ("none", None):
        return similarity
    raise ValueError(f"Expected reduction to be one of ['sum', 'mean', 'none', None] but got {reduction}")


def cosine_similarity(preds: torch.Tensor, target: torch.Tensor, reduction: Optional[str] = "sum") -> torch.Tensor:
    """Row-wise cosine similarity with a final reduction, on the device of the inputs.

    Example:
        >>> import torch
        >>> target = torch.tensor([[1.0, 2.0, 3.0, 4.0], [1.0, 2.0, 3.0, 4.0]])
        >>> preds = torch.tensor([[1.0, 2.0, 3.0, 4.0], [-1.0, -2.0, -3.0, -4.0]])
        >>> round(float(cosine_similarity(preds, target, reduction='mean')), 6)
        0.0
    """
    preds, target = _cosine_similarity_update(preds, target)
    return _cosine_similarity_compute(preds, target, reduction)
