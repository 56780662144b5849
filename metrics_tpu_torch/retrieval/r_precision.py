"""RetrievalRPrecision (counterpart of ``metrics_tpu/retrieval/r_precision.py``)."""

from typing import Tuple

import torch

from metrics_tpu_torch.functional.retrieval.engine import r_precision_per_group
from metrics_tpu_torch.retrieval.base import RetrievalMetric


class RetrievalRPrecision(RetrievalMetric):
    """R-Precision averaged over queries."""

    def _group_scores(self, preds, target, group, n_groups) -> Tuple[torch.Tensor, torch.Tensor]:
        return r_precision_per_group(preds, target, group, n_groups), self._empty_mask(target, group, n_groups)

    def _metric(self, preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        from metrics_tpu_torch.functional.retrieval.r_precision import retrieval_r_precision

        return retrieval_r_precision(preds, target)
