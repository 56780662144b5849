"""CosineSimilarity module metric (counterpart of ``metrics_tpu/regression/cosine_similarity.py``)."""

from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.regression.cosine_similarity import (
    _cosine_similarity_compute,
    _cosine_similarity_update,
)
from metrics_tpu_torch.metric import Metric


class CosineSimilarity(Metric):
    """Row-wise cosine similarity over the stream: the ``(N, D)`` rows in two
    buffer states, gathered in rank order by sync.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CosineSimilarity
        >>> metric = CosineSimilarity(reduction='mean', device='cpu')
        >>> metric.update(torch.tensor([[1.0, 2.0, 3.0, 4.0], [-1.0, -2.0, -3.0, -4.0]]),
        ...               torch.tensor([[1.0, 2.0, 3.0, 4.0], [1.0, 2.0, 3.0, 4.0]]))
        >>> round(float(metric.compute()), 6)
        0.0
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = True
    stackable = False  # buffer states (preds/target) grow with the stream

    def __init__(self, reduction: Optional[str] = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        allowed_reduction = ("sum", "mean", "none", None)
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.reduction = reduction
        self.add_buffer_state("preds")
        self.add_buffer_state("target")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target = _cosine_similarity_update(preds, target)
        self._buffer_append("preds", preds)
        self._buffer_append("target", target)

    def compute(self) -> torch.Tensor:
        return _cosine_similarity_compute(self.buffer_values("preds"), self.buffer_values("target"), self.reduction)
