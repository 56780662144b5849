"""Accuracy module metric (counterpart of ``metrics_tpu/classification/accuracy.py``)."""

from typing import Any, Optional

import torch

from metrics_tpu_torch.classification.stat_scores import StatScores
from metrics_tpu_torch.functional.classification.accuracy import (
    _accuracy_compute,
    _accuracy_update,
    _check_subset_validity,
    _mode,
    _subset_accuracy_compute,
    _subset_accuracy_update,
)
from metrics_tpu_torch.utils.enums import DataType


class Accuracy(StatScores):
    r"""Accuracy = fraction of correctly classified samples.

    Supports micro/macro/weighted/none/samples averaging, multi-dim
    multi-class global/samplewise handling, top-k, and subset accuracy.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy
        >>> target = torch.tensor([0, 1, 2, 3])
        >>> preds = torch.tensor([0, 2, 1, 3])
        >>> metric = Accuracy(num_classes=4, device='cpu')
        >>> metric.update(preds, target)
        >>> float(metric.compute())
        0.5
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        average: str = "micro",
        mdmc_average: Optional[str] = "global",
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        subset_accuracy: bool = False,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        allowed_average = ("micro", "macro", "weighted", "samples", "none", None)
        if average not in allowed_average:
            raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")

        super().__init__(
            reduce="macro" if average in ("weighted", "none", None) else average,
            mdmc_reduce=mdmc_average,
            threshold=threshold,
            top_k=top_k,
            num_classes=num_classes,
            multiclass=multiclass,
            ignore_index=ignore_index,
            validate_args=validate_args,
            **kwargs,
        )
        if average in ("macro", "weighted", "none", None) and (not num_classes or num_classes < 1):
            raise ValueError(f"When you set `average` as {average}, you have to provide the number of classes.")
        if top_k is not None and (not isinstance(top_k, int) or top_k <= 0):
            raise ValueError(f"The `top_k` should be an integer larger than 0, got {top_k}")

        self.average = average
        self.subset_accuracy = subset_accuracy
        self.add_state("correct", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        # the mode is locked by StatScores._pre_update; a direct call of the
        # raw update derives it here
        if self.mode is None:
            self.mode = _mode(
                preds, target, self.threshold, self.top_k, self.num_classes,
                self.multiclass, self.ignore_index, self.validate_args,
            )

        if self.subset_accuracy and _check_subset_validity(self.mode):
            correct, total = _subset_accuracy_update(
                preds, target, threshold=self.threshold, top_k=self.top_k,
                ignore_index=self.ignore_index, validate_args=self.validate_args,
            )
            self.correct = self.correct + correct
            self.total = self.total + total
        else:
            tp, fp, tn, fn = _accuracy_update(
                preds, target, reduce=self.reduce, mdmc_reduce=self.mdmc_reduce,
                threshold=self.threshold, num_classes=self.num_classes, top_k=self.top_k,
                multiclass=self.multiclass, ignore_index=self.ignore_index, mode=self.mode,
                validate_args=self.validate_args,
            )
            self._accumulate(tp, fp, tn, fn)

    def compute(self) -> torch.Tensor:
        if self.mode is None:
            raise RuntimeError("You have to have determined mode.")
        if self.subset_accuracy and _check_subset_validity(self.mode):
            return _subset_accuracy_compute(self.correct, self.total)
        tp, fp, tn, fn = self._get_final_stats()
        return _accuracy_compute(tp, fp, tn, fn, self.average, self.mdmc_reduce, self.mode)
