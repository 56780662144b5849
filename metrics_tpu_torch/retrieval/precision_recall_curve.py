"""RetrievalPrecisionRecallCurve and RetrievalRecallAtFixedPrecision
(counterpart of ``metrics_tpu/retrieval/precision_recall_curve.py``)."""

from typing import Any, Optional, Tuple

import torch

from metrics_tpu_torch.functional.retrieval.engine import (
    _group_counts,
    group_relevant_counts,
    precision_recall_curve_per_group,
)
from metrics_tpu_torch.retrieval.base import RetrievalMetric
from metrics_tpu_torch.utils.compute import _mean


def _retrieval_recall_at_fixed_precision(
    precision: torch.Tensor, recall: torch.Tensor, top_k: torch.Tensor, min_precision: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The largest recall whose precision is at least ``min_precision``, and its k.

    Candidates compare as ``(recall, k)`` tuples, so a tie in recall goes to
    the largest k; with no candidate, or a best recall of 0, k is ``max_k``.
    """
    p, r, k = (x.cpu().tolist() for x in (precision, recall, top_k))
    candidates = [(rv, kv) for pv, rv, kv in zip(p, r, k) if pv >= min_precision]
    max_recall, best_k = max(candidates) if candidates else (0.0, len(k))
    if max_recall == 0.0:
        best_k = len(k)
    device = precision.device
    return torch.tensor(max_recall, dtype=torch.float32, device=device), torch.tensor(best_k, dtype=torch.int32, device=device)


class RetrievalPrecisionRecallCurve(RetrievalMetric):
    """Mean precision and recall over queries at every k in ``1..max_k``.

    ``compute`` returns ``(precision, recall, top_k)``; ``max_k=None`` takes
    the largest query's document count.
    """

    def __init__(
        self,
        max_k: Optional[int] = None,
        adaptive_k: bool = False,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        if max_k is not None and not (isinstance(max_k, int) and max_k > 0):
            raise ValueError("`max_k` has to be a positive integer or None")
        self.max_k = max_k
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.adaptive_k = adaptive_k

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        preds, target, group, n_groups = self._grouped()
        max_k = self.max_k
        if max_k is None:
            max_k = int(_group_counts(group, n_groups).max()) if n_groups else 1
        precision, recall = precision_recall_curve_per_group(
            preds, target, group, n_groups, max_k=max_k, adaptive_k=self.adaptive_k
        )
        empty = group_relevant_counts(target, group, n_groups) == 0
        top_k = torch.arange(1, max_k + 1, dtype=torch.int32, device=preds.device)
        if self.empty_target_action == "error" and bool(empty.any()):
            raise ValueError("`compute` method was provided with a query with no positive target.")
        if self.empty_target_action in ("pos", "neg"):
            fill = torch.full_like(precision, 1.0 if self.empty_target_action == "pos" else 0.0)
            precision = torch.where(empty[:, None], fill, precision)
            recall = torch.where(empty[:, None], fill, recall)
        elif self.empty_target_action == "skip":
            keep = (~empty).to(precision.dtype)
            n_keep = keep.sum()
            w = keep[:, None]
            zeros = torch.zeros(max_k, dtype=precision.dtype, device=precision.device)
            precision = torch.where(n_keep > 0, (precision * w).sum(0) / n_keep.clamp(min=1), zeros)
            recall = torch.where(n_keep > 0, (recall * w).sum(0) / n_keep.clamp(min=1), zeros)
            return precision, recall, top_k
        return _mean(precision, dim=0), _mean(recall, dim=0), top_k


class RetrievalRecallAtFixedPrecision(RetrievalPrecisionRecallCurve):
    """The largest mean recall at a k whose mean precision is at least ``min_precision``,
    and that k: ``compute`` returns ``(recall, k)``."""

    def __init__(
        self,
        min_precision: float = 0.0,
        max_k: Optional[int] = None,
        adaptive_k: bool = False,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            max_k=max_k, adaptive_k=adaptive_k, empty_target_action=empty_target_action,
            ignore_index=ignore_index, **kwargs,
        )
        if not (isinstance(min_precision, float) and 0.0 <= min_precision <= 1.0):
            raise ValueError("`min_precision` has to be a positive float between 0 and 1")
        self.min_precision = min_precision

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:
        precisions, recalls, top_k = super().compute()
        return _retrieval_recall_at_fixed_precision(precisions, recalls, top_k, self.min_precision)
