"""retrieval_normalized_dcg (counterpart of ``metrics_tpu/functional/retrieval/ndcg.py``)."""

from typing import Optional

import torch

from metrics_tpu_torch.functional.retrieval._rank import _check_k, _ranked_targets
from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs


def _dcg(target: torch.Tensor) -> torch.Tensor:
    denom = torch.log2(torch.arange(target.shape[-1], dtype=torch.float32, device=target.device) + 2.0)
    return (target / denom).sum(dim=-1)


def retrieval_normalized_dcg(
    preds: torch.Tensor, target: torch.Tensor, k: Optional[int] = None, validate_args: bool = True
) -> torch.Tensor:
    """nDCG@k of one query; graded (non-binary) targets allowed.

    Example:
        >>> import torch
        >>> round(float(retrieval_normalized_dcg(torch.tensor([.1, .2, .3, 4., 70.]), torch.tensor([10, 0, 0, 1, 5]))), 4)
        0.6957
    """
    _check_k(k)
    preds, target = _check_retrieval_functional_inputs(
        preds, target, allow_non_binary_target=True, validate_args=validate_args
    )
    k = preds.shape[-1] if k is None else k
    tf = target.to(torch.float32)
    ideal_dcg = _dcg(torch.sort(tf, descending=True).values[:k])
    target_dcg = _dcg(_ranked_targets(preds, tf)[:k])
    positive = ideal_dcg > 0
    return torch.where(positive, target_dcg / torch.where(positive, ideal_dcg, torch.ones_like(ideal_dcg)), torch.zeros_like(target_dcg))
