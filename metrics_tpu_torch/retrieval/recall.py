"""RetrievalRecall (counterpart of ``metrics_tpu/retrieval/recall.py``)."""

from typing import Any, Optional, Tuple

import torch

from metrics_tpu_torch.functional.retrieval._rank import _check_k
from metrics_tpu_torch.functional.retrieval.engine import recall_per_group
from metrics_tpu_torch.retrieval.base import RetrievalMetric


class RetrievalRecall(RetrievalMetric):
    """Recall@k averaged over queries."""

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
        return recall_per_group(preds, target, group, n_groups, k=self.k), self._empty_mask(target, group, n_groups)

    def _metric(self, preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        from metrics_tpu_torch.functional.retrieval.recall import retrieval_recall

        return retrieval_recall(preds, target, k=self.k)
