"""CharErrorRate (counterpart of ``metrics_tpu/text/cer.py``)."""

from typing import Any, List, Union

import torch

from metrics_tpu_torch.functional.text.cer import _cer_compute, _cer_update
from metrics_tpu_torch.metric import Metric


class CharErrorRate(Metric):
    """Streaming character error rate over batches of strings.

    An update computes its statistics on the host (the character edit
    distances and the reference characters) and sums them there
    (:meth:`Metric._host_accumulate`): it issues no device operation. The
    float32 states take one add each when they are next read, and sync as
    sums.

    Example:
        >>> from metrics_tpu_torch import CharErrorRate
        >>> metric = CharErrorRate(device="cpu")
        >>> metric.update(["this is the prediction", "there is an other sample"],
        ...               ["this is the reference", "there is another one"])
        >>> round(float(metric.compute()), 4)
        0.3415
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        errors, total = _cer_update(preds, target)
        self._host_accumulate(errors=errors, total=total)

    def compute(self) -> torch.Tensor:
        return _cer_compute(self.errors, self.total)
