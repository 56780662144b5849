"""AveragePrecision module metric (counterpart of ``metrics_tpu/classification/avg_precision.py``)."""

from typing import Any, List, Optional, Union

import torch

from metrics_tpu_torch.functional.classification.average_precision import (
    _average_precision_compute,
    _average_precision_update,
)
from metrics_tpu_torch.metric import Metric


class AveragePrecision(Metric):
    """Area under the precision-recall step curve of the stream.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import AveragePrecision
        >>> pred = torch.tensor([0.0, 1.0, 2.0, 3.0])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> metric = AveragePrecision(pos_label=1, device='cpu')
        >>> metric.update(pred, target)
        >>> float(metric.compute())
        1.0
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    stackable = False  # buffer states (preds/target) grow with the stream

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        average: Optional[str] = "macro",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed_average = ("micro", "macro", "weighted", "none", None)
        if average not in allowed_average:
            raise ValueError(f"Expected argument `average` to be one of {allowed_average}, but got {average}")
        self.num_classes = num_classes
        self.pos_label = pos_label
        self.average = average
        self.add_buffer_state("preds")
        self.add_buffer_state("target")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target, num_classes, pos_label = _average_precision_update(
            preds, target, self.num_classes, self.pos_label, self.average
        )
        self._buffer_append("preds", preds)
        self._buffer_append("target", target)
        self.num_classes = num_classes
        self.pos_label = pos_label

    def compute(self) -> Union[List[torch.Tensor], torch.Tensor]:
        return _average_precision_compute(
            self.buffer_values("preds"), self.buffer_values("target"), self.num_classes, self.pos_label, self.average
        )
