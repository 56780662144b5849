"""The shared shape of the audio module metrics: a float32 score sum and an int32 count."""

from typing import Any

import torch

from metrics_tpu_torch.metric import Metric


class _SignalMean(Metric):
    """The mean of a per-signal score over the stream.

    A subclass names its sum state (``_sum_state``, as the JAX package names
    it) and scores a batch in ``_scores``; the count is the number of scores.
    """

    _sum_state = "sum"

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state(self._sum_state, default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def _scores(self, preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        scores = self._scores(preds, target)
        setattr(self, self._sum_state, getattr(self, self._sum_state) + scores.sum())
        self.total = self.total + scores.numel()

    def compute(self) -> torch.Tensor:
        return getattr(self, self._sum_state) / self.total
