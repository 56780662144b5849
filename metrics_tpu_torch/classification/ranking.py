"""Multilabel ranking module metrics (counterpart of ``metrics_tpu/classification/ranking.py``)."""

from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.classification.ranking import (
    _coverage_error_update,
    _label_ranking_average_precision_update,
    _label_ranking_loss_update,
)
from metrics_tpu_torch.metric import Metric


class _RankingBase(Metric):
    """A float32 ``measure`` summed over samples, the int32 sample count ``total``, and the
    float32 summed sample ``weight`` (which grows by the sample count where no weights are
    given), so ``compute()`` is always ``measure / weight``."""

    is_differentiable = False
    full_state_update = False
    _update_fn: Any = None

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("measure", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("weight", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor, sample_weight: Optional[torch.Tensor] = None) -> None:
        measure, total, weight_sum = self._update_fn(preds, target, sample_weight)
        self.measure = self.measure + measure
        self.total = self.total + total
        self.weight = self.weight + (weight_sum if weight_sum is not None else float(total))

    def compute(self) -> torch.Tensor:
        return self.measure / self.weight


class CoverageError(_RankingBase):
    """How far down each row's ranking one must go to cover all its true labels, on average.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CoverageError
        >>> metric = CoverageError(device='cpu')
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.35]])
        >>> metric.update(preds, torch.tensor([[1, 0, 1], [0, 0, 0], [0, 1, 1]]))
        >>> round(float(metric.compute()), 6)
        1.333333
    """

    higher_is_better = False
    _update_fn = staticmethod(_coverage_error_update)


class LabelRankingAveragePrecision(_RankingBase):
    """Mean share of relevant labels ranked at or above each relevant label.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import LabelRankingAveragePrecision
        >>> metric = LabelRankingAveragePrecision(device='cpu')
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.35]])
        >>> metric.update(preds, torch.tensor([[1, 0, 0], [0, 0, 1], [0, 1, 1]]))
        >>> round(float(metric.compute()), 6)
        0.777778
    """

    higher_is_better = True
    _update_fn = staticmethod(_label_ranking_average_precision_update)


class LabelRankingLoss(_RankingBase):
    """Mean share of (relevant, irrelevant) label pairs ordered wrong.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import LabelRankingLoss
        >>> metric = LabelRankingLoss(device='cpu')
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.35]])
        >>> metric.update(preds, torch.tensor([[1, 0, 0], [0, 0, 1], [0, 1, 1]]))
        >>> round(float(metric.compute()), 6)
        0.333333
    """

    higher_is_better = False
    _update_fn = staticmethod(_label_ranking_loss_update)
