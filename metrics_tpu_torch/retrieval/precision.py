"""RetrievalPrecision (counterpart of ``metrics_tpu/retrieval/precision.py``)."""

from typing import Any, Optional, Tuple

import torch

from metrics_tpu_torch.functional.retrieval._rank import _check_k
from metrics_tpu_torch.functional.retrieval.engine import precision_per_group
from metrics_tpu_torch.retrieval.base import RetrievalMetric


class RetrievalPrecision(RetrievalMetric):
    """Precision@k averaged over queries.

    Args:
        k: consider only the top k documents of each query (None: all).
        adaptive_k: per query, ``min(k, n_documents)`` as the denominator.
    """

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        k: Optional[int] = None,
        adaptive_k: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        _check_k(k)
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.k = k
        self.adaptive_k = adaptive_k

    def _group_scores(self, preds, target, group, n_groups) -> Tuple[torch.Tensor, torch.Tensor]:
        scores = precision_per_group(preds, target, group, n_groups, k=self.k, adaptive_k=self.adaptive_k)
        return scores, self._empty_mask(target, group, n_groups)

    def _metric(self, preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        from metrics_tpu_torch.functional.retrieval.precision import retrieval_precision

        return retrieval_precision(preds, target, k=self.k, adaptive_k=self.adaptive_k)
