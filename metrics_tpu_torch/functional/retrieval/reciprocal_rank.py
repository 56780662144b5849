"""retrieval_reciprocal_rank (counterpart of ``metrics_tpu/functional/retrieval/reciprocal_rank.py``)."""

import torch

from metrics_tpu_torch.functional.retrieval._rank import _ranked_targets
from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs


def retrieval_reciprocal_rank(preds: torch.Tensor, target: torch.Tensor, validate_args: bool = True) -> torch.Tensor:
    """Reciprocal rank of the first relevant document, 0 without one.

    Example:
        >>> import torch
        >>> retrieval_reciprocal_rank(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([False, True, False]))
        tensor(0.5000)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target, validate_args=validate_args)
    t = _ranked_targets(preds, target)
    ranks = torch.arange(1, t.shape[0] + 1, dtype=torch.float32, device=t.device)
    first = torch.where(t > 0, ranks, torch.full_like(ranks, float("inf"))).min()
    return torch.where(torch.isfinite(first), 1.0 / first, torch.zeros_like(first))
