"""SpearmanCorrCoef module metric (counterpart of ``metrics_tpu/regression/spearman.py``)."""

from typing import Any

import torch

from metrics_tpu_torch.functional.regression.spearman import _spearman_corrcoef_compute, _spearman_corrcoef_update
from metrics_tpu_torch.metric import Metric


class SpearmanCorrCoef(Metric):
    """Rank correlation needs the whole sample: two buffer states, gathered in rank order by sync.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SpearmanCorrCoef
        >>> metric = SpearmanCorrCoef(device='cpu')
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0, 1.0]), torch.tensor([3.0, -0.5, 2.0, 7.0, 4.0]))
        >>> round(float(metric.compute()), 4)
        0.7
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    stackable = False  # buffer states (preds/target) grow with the stream

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_buffer_state("preds")
        self.add_buffer_state("target")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target = _spearman_corrcoef_update(preds, target)
        self._buffer_append("preds", preds)
        self._buffer_append("target", target)

    def compute(self) -> torch.Tensor:
        return _spearman_corrcoef_compute(self.buffer_values("preds"), self.buffer_values("target"))
