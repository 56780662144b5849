"""Binned (constant-memory) curve metrics
(counterpart of ``metrics_tpu/classification/binned_precision_recall.py``).

The states are ``(C, T)`` float32 sums of true positives, false positives
and false negatives at ``T`` fixed thresholds.  The JAX package forms one
``(N, C, T)`` comparison per batch and lets XLA fuse it; eager PyTorch would
materialise it, so the update walks the rows in chunks whose ``(rows, C, T)``
intermediates stay under a fixed size and sums each chunk in integers.
"""

from typing import Any, List, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.average_precision import (
    _reduce_average_precision,
    _step_integrals,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import _linspace_thresholds, _x32, to_onehot

METRIC_EPS = 1e-6
_CHUNK_ELEMENTS = 1 << 24  # elements of one (rows, C, T) comparison


def _binned_counts(
    preds: torch.Tensor,
    target: torch.Tensor,
    thresholds: torch.Tensor,
    chunk_elements: int = _CHUNK_ELEMENTS,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """int64 ``(C, T)`` tp, fp and fn of ``preds >= thresholds`` against the bool
    ``target`` (both ``(N, C)``), over chunks of rows."""
    n, c = preds.shape
    rows = max(1, chunk_elements // max(1, c * thresholds.numel()))
    tp = torch.zeros((c, thresholds.numel()), dtype=torch.int64, device=preds.device)
    predicted = torch.zeros_like(tp)
    for start in range(0, n, rows):
        hit = preds[start : start + rows, :, None] >= thresholds
        tp += (hit & target[start : start + rows, :, None]).sum(0)
        predicted += hit.sum(0)
    return tp, predicted - tp, target.sum(0)[:, None] - tp


class BinnedPrecisionRecallCurve(Metric):
    """precision and recall at ``thresholds`` fixed thresholds (evenly spaced in
    ``[0, 1]`` when an int), with the ``(1, 0)`` end point appended.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import BinnedPrecisionRecallCurve
        >>> metric = BinnedPrecisionRecallCurve(num_classes=1, thresholds=5, device='cpu')
        >>> metric.update(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))
        >>> precision, recall, thresholds = metric.compute()
        >>> thresholds
        tensor([0.0000, 0.2500, 0.5000, 0.7500, 1.0000])
        >>> recall
        tensor([1.0000, 1.0000, 0.5000, 0.5000, 0.0000, 0.0000])
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False
    stackable = True  # fixed (num_classes, num_thresholds) sum states

    def __init__(self, num_classes: int, thresholds: Union[int, torch.Tensor, List[float]] = 100, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        if isinstance(thresholds, int):
            self.num_thresholds = thresholds
            self.thresholds = torch.from_numpy(_linspace_thresholds(thresholds)).to(self.device)
        elif thresholds is not None:
            if not isinstance(thresholds, (list, torch.Tensor)):
                raise ValueError("Expected argument `thresholds` to either be an integer, list of floats or a tensor")
            self.thresholds = _x32(torch.as_tensor(thresholds)).to(self.device)
            self.num_thresholds = self.thresholds.numel()
        for name in ("TPs", "FPs", "FNs"):
            self.add_state(name, default=torch.zeros((num_classes, self.num_thresholds), dtype=torch.float32),
                           dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target = _x32(torch.as_tensor(preds)), _x32(torch.as_tensor(target))
        if preds.ndim == target.ndim == 1:
            preds = preds.reshape(-1, 1)
            target = target.reshape(-1, 1)
        if preds.ndim == target.ndim + 1:
            target = to_onehot(target, num_classes=self.num_classes)
        tp, fp, fn = _binned_counts(preds, target == 1, self.thresholds)
        self.TPs = self.TPs + tp
        self.FPs = self.FPs + fp
        self.FNs = self.FNs + fn

    def _curves(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """float32 ``(C, T + 1)`` precision and recall."""
        precisions = (self.TPs + METRIC_EPS) / (self.TPs + self.FPs + METRIC_EPS)
        recalls = self.TPs / (self.TPs + self.FNs + METRIC_EPS)
        ones = torch.ones((self.num_classes, 1), dtype=precisions.dtype, device=self.device)
        return torch.cat([precisions, ones], 1), torch.cat([recalls, 0 * ones], 1)

    def compute(self) -> Union[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]]:
        precisions, recalls = self._curves()
        if self.num_classes == 1:
            return precisions[0, :], recalls[0, :], self.thresholds
        return list(precisions), list(recalls), [self.thresholds for _ in range(self.num_classes)]


class BinnedAveragePrecision(BinnedPrecisionRecallCurve):
    """Average precision from the binned curve, per class.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import BinnedAveragePrecision
        >>> metric = BinnedAveragePrecision(num_classes=1, thresholds=5, device='cpu')
        >>> metric.update(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))
        >>> round(float(metric.compute()), 6)
        0.833333
    """

    higher_is_better = True

    def compute(self) -> Union[List[torch.Tensor], torch.Tensor]:  # type: ignore[override]
        precisions, recalls = self._curves()
        points = torch.full((self.num_classes,), precisions.shape[1], device=self.device)
        return _reduce_average_precision(_step_integrals(precisions, recalls, points), self.num_classes, average=None)


class BinnedRecallAtFixedPrecision(BinnedPrecisionRecallCurve):
    """The highest recall at a precision of at least ``min_precision``, and its threshold
    (1e6 where no threshold reaches it).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import BinnedRecallAtFixedPrecision
        >>> metric = BinnedRecallAtFixedPrecision(num_classes=1, min_precision=0.9, thresholds=5, device='cpu')
        >>> metric.update(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))
        >>> recall, threshold = metric.compute()
        >>> round(float(recall), 6), float(threshold)
        (0.5, 0.75)
    """

    higher_is_better = True

    def __init__(
        self,
        num_classes: int,
        min_precision: float,
        thresholds: Union[int, torch.Tensor, List[float]] = 100,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes=num_classes, thresholds=thresholds, **kwargs)
        self.min_precision = min_precision

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:  # type: ignore[override]
        """Among the thresholds tying on the highest recall, the highest precision
        wins, then the highest threshold; the appended end point has no threshold
        and takes no part."""
        precisions, recalls = self._curves()
        thr = self.thresholds
        n = thr.numel()
        p, r = precisions[:, :n], recalls[:, :n]
        valid = p >= self.min_precision
        r_m = torch.where(valid, r, -torch.inf)
        max_r = r_m.max(1).values
        tie_r = valid & (r_m == max_r[:, None])
        p_m = torch.where(tie_r, p, -torch.inf)
        max_p = p_m.max(1).values
        tie_rp = tie_r & (p == max_p[:, None])
        best_thresholds = torch.where(tie_rp, thr[None, :], -torch.inf).max(1).values
        max_recall = torch.where(valid.any(1), max_r, 0.0)
        best_thresholds = torch.where(max_recall == 0, 1e6, best_thresholds).to(thr.dtype)
        if self.num_classes == 1:
            return max_recall[0], best_thresholds[0]
        return max_recall, best_thresholds
