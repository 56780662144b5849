"""RetrievalMAP (counterpart of ``metrics_tpu/retrieval/average_precision.py``)."""

from typing import Tuple

import torch

from metrics_tpu_torch.functional.retrieval.engine import average_precision_per_group
from metrics_tpu_torch.retrieval.base import RetrievalMetric


class RetrievalMAP(RetrievalMetric):
    """Mean Average Precision over queries."""

    def _group_scores(self, preds, target, group, n_groups) -> Tuple[torch.Tensor, torch.Tensor]:
        return average_precision_per_group(preds, target, group, n_groups), self._empty_mask(target, group, n_groups)

    def _metric(self, preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        from metrics_tpu_torch.functional.retrieval.average_precision import retrieval_average_precision

        return retrieval_average_precision(preds, target)
