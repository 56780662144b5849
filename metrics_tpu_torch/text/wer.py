"""WordErrorRate (counterpart of ``metrics_tpu/text/wer.py``)."""

from typing import Any, List, Union

import torch

from metrics_tpu_torch.functional.text.wer import _wer_compute, _wer_update
from metrics_tpu_torch.metric import Metric


class WordErrorRate(Metric):
    """Streaming word error rate over batches of strings.

    An update computes its statistics on the host (the edit distances and
    the reference words) and sums them there
    (:meth:`Metric._host_accumulate`): it issues no device operation. The
    float32 states take one add each when they are next read, and sync as
    sums.

    Example:
        >>> from metrics_tpu_torch import WordErrorRate
        >>> metric = WordErrorRate(device="cpu")
        >>> metric.update(["this is the prediction", "there is an other sample"],
        ...               ["this is the reference", "there is another one"])
        >>> float(metric.compute())
        0.5
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        errors, total = _wer_update(preds, target)
        self._host_accumulate(errors=errors, total=total)

    def compute(self) -> torch.Tensor:
        return _wer_compute(self.errors, self.total)
