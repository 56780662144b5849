"""AUROC module metric (counterpart of ``metrics_tpu/classification/auroc.py``)."""

from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.classification.auroc import _auroc_compute, _auroc_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.enums import DataType


class AUROC(Metric):
    """Area under the ROC curve of the stream.

    The scores and targets stay on the metric's device in buffer states; an
    update of float scores reads nothing back from the device.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import AUROC
        >>> preds = torch.tensor([0.13, 0.26, 0.08, 0.19, 0.34])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> metric = AUROC(pos_label=1, device='cpu')
        >>> metric.update(preds, target)
        >>> float(metric.compute())
        0.5
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    stackable = False  # buffer states (preds/target) grow with the stream
    # the data-determined mode must survive a checkpoint restore
    _ckpt_attrs = ("mode",)

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        average: Optional[str] = "macro",
        max_fpr: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.pos_label = pos_label
        self.average = average
        self.max_fpr = max_fpr

        allowed_average = (None, "macro", "weighted", "micro")
        if average not in allowed_average:
            raise ValueError(
                f"Argument `average` expected to be one of the following: {allowed_average} but got {average}"
            )
        if max_fpr is not None and (not isinstance(max_fpr, float) or not 0 < max_fpr <= 1):
            raise ValueError(f"`max_fpr` should be a float in range (0, 1], got: {max_fpr}")

        self.mode: Optional[DataType] = None
        self.add_buffer_state("preds")
        self.add_buffer_state("target")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target, mode = _auroc_update(preds, target)
        self._buffer_append("preds", preds)
        self._buffer_append("target", target)
        if self.mode is not None and self.mode != mode:
            raise ValueError(
                "The mode of data (binary, multi-label, multi-class) should be constant, but changed"
                f" between batches from {self.mode} to {mode}"
            )
        self.mode = mode

    def compute(self) -> torch.Tensor:
        if not self.mode:
            raise RuntimeError("You have to have determined mode.")
        return _auroc_compute(
            self.buffer_values("preds"), self.buffer_values("target"), self.mode,
            self.num_classes, self.pos_label, self.average, self.max_fpr,
        )
