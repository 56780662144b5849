"""RetrievalFallOut (counterpart of ``metrics_tpu/retrieval/fall_out.py``)."""

from typing import Any, Optional, Tuple

import torch

from metrics_tpu_torch.functional.retrieval._rank import _check_k
from metrics_tpu_torch.functional.retrieval.engine import fall_out_per_group, group_relevant_counts
from metrics_tpu_torch.retrieval.base import RetrievalMetric


class RetrievalFallOut(RetrievalMetric):
    """Fall-out@k averaged over queries.

    Lower is better; a query is "empty" when it has no *negative* target, and
    such a query scores 1 by default (``empty_target_action="pos"``).
    """

    higher_is_better = False
    _empty_kind = "negative"

    def __init__(
        self,
        empty_target_action: str = "pos",
        ignore_index: Optional[int] = None,
        k: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        _check_k(k)
        self.k = k

    def _empty_mask(self, target: torch.Tensor, group: torch.Tensor, n_groups: int) -> torch.Tensor:
        n_total = group_relevant_counts(torch.ones_like(target), group, n_groups)
        return (n_total - group_relevant_counts(target, group, n_groups)) == 0

    def _group_scores(self, preds, target, group, n_groups) -> Tuple[torch.Tensor, torch.Tensor]:
        return fall_out_per_group(preds, target, group, n_groups, k=self.k), self._empty_mask(target, group, n_groups)

    def _metric(self, preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        from metrics_tpu_torch.functional.retrieval.fall_out import retrieval_fall_out

        return retrieval_fall_out(preds, target, k=self.k)
