"""Dice module metric (counterpart of ``metrics_tpu/classification/dice.py``)."""

from typing import Any

import torch

from metrics_tpu_torch.classification.precision_recall import _PrecisionRecallBase
from metrics_tpu_torch.functional.classification.dice import _dice_compute


class Dice(_PrecisionRecallBase):
    """Dice = 2 tp / (2 tp + fp + fn).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Dice
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> metric = Dice(average='micro', device='cpu')
        >>> metric.update(preds, target)
        >>> float(metric.compute())
        0.25
    """

    def __init__(self, zero_division: int = 0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_division = zero_division

    def compute(self) -> torch.Tensor:
        tp, fp, _, fn = self._get_final_stats()
        return _dice_compute(tp, fp, fn, self.average, self.mdmc_reduce, self.zero_division)
