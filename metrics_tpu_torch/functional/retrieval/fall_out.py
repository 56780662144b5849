"""retrieval_fall_out (counterpart of ``metrics_tpu/functional/retrieval/fall_out.py``)."""

from typing import Optional

import torch

from metrics_tpu_torch.functional.retrieval._rank import _check_k, _ranked_targets
from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs


def retrieval_fall_out(
    preds: torch.Tensor, target: torch.Tensor, k: Optional[int] = None, validate_args: bool = True
) -> torch.Tensor:
    """Fall-out@k: the share of the non-relevant documents that the top k retrieve.

    Example:
        >>> import torch
        >>> retrieval_fall_out(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]), k=2)
        tensor(1.)
    """
    _check_k(k)
    preds, target = _check_retrieval_functional_inputs(preds, target, validate_args=validate_args)
    if k is None:
        k = preds.shape[0]
    neg = 1 - _ranked_targets(preds, target)
    hits = neg[: min(k, preds.shape[0])].sum()
    n_neg = neg.sum()
    return torch.where(n_neg > 0, hits / n_neg.clamp(min=1.0), torch.zeros_like(hits))
