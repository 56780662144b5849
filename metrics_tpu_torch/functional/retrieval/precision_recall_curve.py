"""retrieval_precision_recall_curve
(counterpart of ``metrics_tpu/functional/retrieval/precision_recall_curve.py``)."""

from typing import Optional, Tuple

import torch

from metrics_tpu_torch.functional.retrieval._rank import _ranked_targets, _where_relevant
from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs


def retrieval_precision_recall_curve(
    preds: torch.Tensor,
    target: torch.Tensor,
    max_k: Optional[int] = None,
    adaptive_k: bool = False,
    validate_args: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Precision and recall at every k in ``1..max_k`` for one query, and the k (int32).

    Example:
        >>> import torch
        >>> p, r, k = retrieval_precision_recall_curve(
        ...     torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]), max_k=2)
        >>> p, r, k
        (tensor([1.0000, 0.5000]), tensor([0.5000, 0.5000]), tensor([1, 2], dtype=torch.int32))
    """
    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")
    preds, target = _check_retrieval_functional_inputs(preds, target, validate_args=validate_args)
    n = preds.shape[-1]
    if max_k is None:
        max_k = n
    if not (isinstance(max_k, int) and max_k > 0):
        raise ValueError("`max_k` has to be a positive integer or None")
    topk = torch.arange(1, max_k + 1, dtype=torch.int32, device=preds.device)
    if adaptive_k and max_k > n:
        topk = topk.clamp(max=n)
    t = _ranked_targets(preds, target)[: min(max_k, n)]
    relevant = torch.cumsum(torch.nn.functional.pad(t, (0, max(0, max_k - t.shape[0]))), 0)
    n_rel = target.sum()
    recall = _where_relevant(n_rel, relevant / n_rel.clamp(min=1.0))
    precision = _where_relevant(n_rel, relevant / topk)
    return precision, recall, topk
