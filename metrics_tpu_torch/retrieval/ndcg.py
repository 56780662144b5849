"""RetrievalNormalizedDCG (counterpart of ``metrics_tpu/retrieval/ndcg.py``)."""

from typing import Any, Optional, Tuple

import torch

from metrics_tpu_torch.functional.retrieval._rank import _check_k
from metrics_tpu_torch.functional.retrieval.engine import ndcg_per_group
from metrics_tpu_torch.retrieval.base import RetrievalMetric


class RetrievalNormalizedDCG(RetrievalMetric):
    """nDCG@k averaged over queries; graded (non-binary) relevance allowed."""

    allow_non_binary_target = True

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        k: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        _check_k(k)
        self.k = k

    def _group_scores(self, preds, target, group, n_groups) -> Tuple[torch.Tensor, torch.Tensor]:
        return ndcg_per_group(preds, target, group, n_groups, k=self.k), self._empty_mask(target, group, n_groups)

    def _metric(self, preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        from metrics_tpu_torch.functional.retrieval.ndcg import retrieval_normalized_dcg

        return retrieval_normalized_dcg(preds, target, k=self.k)
