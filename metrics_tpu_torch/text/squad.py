"""SQuAD (counterpart of ``metrics_tpu/text/squad.py``)."""

from typing import Any, Dict

import torch

from metrics_tpu_torch.functional.text.squad import (
    PREDS_TYPE,
    TARGETS_TYPE,
    _squad_compute,
    _squad_input_check,
    _squad_update,
)
from metrics_tpu_torch.metric import Metric


class SQuAD(Metric):
    """Streaming SQuAD v1.1 exact match and F1: three sums, summed on the host
    (:meth:`Metric._host_accumulate`).

    Example:
        >>> from metrics_tpu_torch import SQuAD
        >>> metric = SQuAD(device="cpu")
        >>> metric.update([{"prediction_text": "1976", "id": "q1"}],
        ...               [{"answers": {"answer_start": [97], "text": ["1976"]}, "id": "q1"}])
        >>> {k: float(v) for k, v in metric.compute().items()}
        {'exact_match': 100.0, 'f1': 100.0}
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("f1_score", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("exact_match", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: PREDS_TYPE, target: TARGETS_TYPE) -> None:
        preds_dict, targets_dict = _squad_input_check(preds, target)
        f1, exact_match, total = _squad_update(preds_dict, targets_dict)
        self._host_accumulate(f1_score=f1, exact_match=exact_match, total=total)

    def compute(self) -> Dict[str, torch.Tensor]:
        return _squad_compute(self.f1_score, self.exact_match, self.total)
