"""retrieval_hit_rate (counterpart of ``metrics_tpu/functional/retrieval/hit_rate.py``)."""

from typing import Optional

import torch

from metrics_tpu_torch.functional.retrieval._rank import _check_k, _ranked_targets
from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs


def retrieval_hit_rate(
    preds: torch.Tensor, target: torch.Tensor, k: Optional[int] = None, validate_args: bool = True
) -> torch.Tensor:
    """HitRate@k of one query: 1 where a relevant document is in the top k.

    Example:
        >>> import torch
        >>> retrieval_hit_rate(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]), k=2)
        tensor(1.)
    """
    _check_k(k)
    preds, target = _check_retrieval_functional_inputs(preds, target, validate_args=validate_args)
    if k is None:
        k = preds.shape[0]
    hits = _ranked_targets(preds, target)[: min(k, preds.shape[0])].sum()
    return (hits > 0).to(torch.float32)
