"""RetrievalMRR (counterpart of ``metrics_tpu/retrieval/reciprocal_rank.py``)."""

from typing import Tuple

import torch

from metrics_tpu_torch.functional.retrieval.engine import reciprocal_rank_per_group
from metrics_tpu_torch.retrieval.base import RetrievalMetric


class RetrievalMRR(RetrievalMetric):
    """Mean Reciprocal Rank over queries.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalMRR
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalMRR(device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> float(metric.compute())
        1.0
    """

    def _group_scores(self, preds, target, group, n_groups) -> Tuple[torch.Tensor, torch.Tensor]:
        return reciprocal_rank_per_group(preds, target, group, n_groups), self._empty_mask(target, group, n_groups)

    def _metric(self, preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        from metrics_tpu_torch.functional.retrieval.reciprocal_rank import retrieval_reciprocal_rank

        return retrieval_reciprocal_rank(preds, target)
