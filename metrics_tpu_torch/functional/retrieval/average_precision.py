"""retrieval_average_precision (counterpart of ``metrics_tpu/functional/retrieval/average_precision.py``)."""

import torch

from metrics_tpu_torch.functional.retrieval._rank import _ranked_targets, _where_relevant
from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs


def retrieval_average_precision(preds: torch.Tensor, target: torch.Tensor, validate_args: bool = True) -> torch.Tensor:
    """Average precision of one query's ranked documents.

    Example:
        >>> import torch
        >>> retrieval_average_precision(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]))
        tensor(0.8333)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target, validate_args=validate_args)
    t = _ranked_targets(preds, target)
    ranks = torch.arange(1, t.shape[0] + 1, dtype=torch.float32, device=t.device)
    prec_at_hit = torch.where(t > 0, torch.cumsum(t, 0) / ranks, torch.zeros_like(t))
    n_rel = t.sum()
    return _where_relevant(n_rel, prec_at_hit.sum() / n_rel.clamp(min=1.0))
