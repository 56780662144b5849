"""WordInfoLost (counterpart of ``metrics_tpu/text/wil.py``)."""

from typing import Any, List, Union

import torch

from metrics_tpu_torch.functional.text.wil import _wil_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.streaming._threefry import fma32


class WordInfoLost(Metric):
    """Streaming word information lost over batches of strings.

    An update computes its statistics on the host (minus the hits, the
    reference words and the predicted words) and sums them there
    (:meth:`Metric._host_accumulate`): it issues no device operation. The
    float32 states take one add each when they are next read, and sync as
    sums.

    Example:
        >>> from metrics_tpu_torch import WordInfoLost
        >>> metric = WordInfoLost(device="cpu")
        >>> metric.update(["this is the prediction", "there is an other sample"],
        ...               ["this is the reference", "there is another one"])
        >>> round(float(metric.compute()), 4)
        0.6528
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("target_total", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("preds_total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        errors, target_total, preds_total = _wil_update(preds, target)
        self._host_accumulate(errors=errors, target_total=target_total, preds_total=preds_total)

    def compute(self) -> torch.Tensor:
        # 1 - (e / t) * (e / p) as one fused multiply-add: the JAX package jits
        # this compute, and XLA contracts it so (its eager functional does not)
        errors = self.errors
        return fma32(-(errors / self.target_total), errors / self.preds_total, torch.ones_like(errors))
