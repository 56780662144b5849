"""BLEUScore (counterpart of ``metrics_tpu/text/bleu.py``)."""

from typing import Any, Optional, Sequence, Union

import torch

from metrics_tpu_torch.functional.text.bleu import (
    _bleu_normalize_inputs,
    _bleu_score_compute,
    _bleu_score_update,
    _tokenize_fn,
)
from metrics_tpu_torch.metric import Metric


class BLEUScore(Metric):
    """Streaming corpus BLEU: ``(n_gram,)`` numerator and denominator sums and
    two length sums, counted and summed on the host
    (:meth:`Metric._host_accumulate`), so an update issues no device
    operation; the score is tensor math on ``device``.

    Example:
        >>> from metrics_tpu_torch import BLEUScore
        >>> metric = BLEUScore(device="cpu")
        >>> metric.update(['the cat is on the mat'], [['there is a cat on the mat', 'a cat is on the mat']])
        >>> round(float(metric.compute()), 4)
        0.7598
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        weights: Optional[Sequence[float]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.n_gram = n_gram
        self.smooth = smooth
        _, _, self.weights = _bleu_normalize_inputs([], [], n_gram, weights)
        self.add_state("preds_len", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("target_len", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("numerator", default=torch.zeros(n_gram), dist_reduce_fx="sum")
        self.add_state("denominator", default=torch.zeros(n_gram), dist_reduce_fx="sum")

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        preds_, target_, _ = _bleu_normalize_inputs(preds, target, self.n_gram, None)
        numerator, denominator, preds_len, target_len = _bleu_score_update(
            preds_, target_, self.n_gram, self._tokenizer()
        )
        self._host_accumulate(
            preds_len=preds_len, target_len=target_len, numerator=numerator, denominator=denominator
        )

    def _tokenizer(self):
        return _tokenize_fn

    def compute(self) -> torch.Tensor:
        return _bleu_score_compute(
            self.preds_len, self.target_len, self.numerator, self.denominator, self.n_gram, self.weights, self.smooth
        )
