"""retrieval_recall (counterpart of ``metrics_tpu/functional/retrieval/recall.py``)."""

from typing import Optional

import torch

from metrics_tpu_torch.functional.retrieval._rank import _check_k, _ranked_targets, _where_relevant
from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs


def retrieval_recall(
    preds: torch.Tensor, target: torch.Tensor, k: Optional[int] = None, validate_args: bool = True
) -> torch.Tensor:
    """Recall@k of one query.

    Example:
        >>> import torch
        >>> retrieval_recall(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]), k=2)
        tensor(0.5000)
    """
    _check_k(k)
    preds, target = _check_retrieval_functional_inputs(preds, target, validate_args=validate_args)
    if k is None:
        k = preds.shape[0]
    hits = _ranked_targets(preds, target)[: min(k, preds.shape[0])].sum()
    n_rel = target.sum()
    return _where_relevant(n_rel, hits / n_rel.clamp(min=1.0))
