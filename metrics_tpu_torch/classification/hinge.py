"""HingeLoss module metric (counterpart of ``metrics_tpu/classification/hinge.py``)."""

from typing import Any, Optional, Union

import torch

from metrics_tpu_torch.functional.classification.hinge import (
    _MODE_ERROR,
    MulticlassMode,
    _hinge_compute,
    _hinge_update,
)
from metrics_tpu_torch.metric import Metric


class HingeLoss(Metric):
    """Mean hinge loss over the stream.

    ``measure`` starts as a float32 scalar; one-vs-all turns it into a ``(C,)``
    vector on the first update (one loss per class), and ``reset()`` makes it a
    scalar again, as in the JAX package.  ``total`` is an int32 sample count.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import HingeLoss
        >>> metric = HingeLoss(device='cpu')
        >>> metric.update(torch.tensor([-2.2, 2.4, 0.1]), torch.tensor([0, 1, 1]))
        >>> round(float(metric.compute()), 6)
        0.3
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        squared: bool = False,
        multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if multiclass_mode not in (None, MulticlassMode.CRAMMER_SINGER, MulticlassMode.ONE_VS_ALL):
            raise ValueError(f"{_MODE_ERROR} got {multiclass_mode}.")
        self.squared = squared
        self.multiclass_mode = multiclass_mode
        self.add_state("measure", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        measure, total = _hinge_update(preds, target, squared=self.squared, multiclass_mode=self.multiclass_mode)
        self.measure = measure + self.measure
        self.total = total + self.total

    def compute(self) -> torch.Tensor:
        return _hinge_compute(self.measure, self.total)
