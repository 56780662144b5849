"""retrieval_precision (counterpart of ``metrics_tpu/functional/retrieval/precision.py``)."""

from typing import Optional

import torch

from metrics_tpu_torch.functional.retrieval._rank import _check_k, _ranked_targets, _where_relevant
from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs


def retrieval_precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    k: Optional[int] = None,
    adaptive_k: bool = False,
    validate_args: bool = True,
) -> torch.Tensor:
    """Precision@k of one query.

    Example:
        >>> import torch
        >>> retrieval_precision(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]), k=2)
        tensor(0.5000)
    """
    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")
    _check_k(k)
    preds, target = _check_retrieval_functional_inputs(preds, target, validate_args=validate_args)
    n = preds.shape[0]
    if k is None or (adaptive_k and k > n):
        k = n
    hits = _ranked_targets(preds, target)[: min(k, n)].sum()
    return _where_relevant(target.sum(), hits / torch.full((), k, dtype=hits.dtype, device=hits.device))
