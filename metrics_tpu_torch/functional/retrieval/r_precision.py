"""retrieval_r_precision (counterpart of ``metrics_tpu/functional/retrieval/r_precision.py``)."""

import torch

from metrics_tpu_torch.functional.retrieval._rank import _ranked_targets, _where_relevant
from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs


def retrieval_r_precision(preds: torch.Tensor, target: torch.Tensor, validate_args: bool = True) -> torch.Tensor:
    """R-Precision: precision in the top R, R the number of relevant documents.

    Example:
        >>> import torch
        >>> retrieval_r_precision(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]))
        tensor(0.5000)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target, validate_args=validate_args)
    t = _ranked_targets(preds, target)
    n_rel = t.sum()
    rank = torch.arange(t.shape[0], dtype=torch.float32, device=t.device)
    hits = torch.where(rank < n_rel, t, torch.zeros_like(t)).sum()
    return _where_relevant(n_rel, hits / n_rel.clamp(min=1.0))
