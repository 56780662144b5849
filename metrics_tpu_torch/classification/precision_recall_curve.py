"""PrecisionRecallCurve module metric
(counterpart of ``metrics_tpu/classification/precision_recall_curve.py``).

The scores and targets of every batch stay on the metric's device in two
buffer states (``preds`` and ``target``, padded and grown by doubling); the
curve is swept there once, in ``compute``.  The constant-memory alternative
is ``BinnedPrecisionRecallCurve``.
"""

from typing import Any, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    _precision_recall_curve_compute,
    _precision_recall_curve_update,
)
from metrics_tpu_torch.metric import Metric


class PrecisionRecallCurve(Metric):
    """precision, recall and thresholds at every distinct score of the stream.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PrecisionRecallCurve
        >>> metric = PrecisionRecallCurve(pos_label=1, device='cpu')
        >>> metric.update(torch.tensor([0.0, 1.0]), torch.tensor([0, 1]))
        >>> metric.update(torch.tensor([2.0, 3.0]), torch.tensor([1, 0]))
        >>> precision, recall, thresholds = metric.compute()
        >>> recall
        tensor([1.0000, 0.5000, 0.0000, 0.0000])
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(self, num_classes: Optional[int] = None, pos_label: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.pos_label = pos_label
        self.add_buffer_state("preds")
        self.add_buffer_state("target")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target, num_classes, pos_label = _precision_recall_curve_update(
            preds, target, self.num_classes, self.pos_label
        )
        self._buffer_append("preds", preds)
        self._buffer_append("target", target)
        self.num_classes = num_classes
        self.pos_label = pos_label

    def compute(self) -> Union[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]]:
        return _precision_recall_curve_compute(
            self.buffer_values("preds"), self.buffer_values("target"), self.num_classes, self.pos_label
        )
