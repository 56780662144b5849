"""CHRFScore (counterpart of ``metrics_tpu/text/chrf.py``)."""

from typing import Any, Sequence, Union

import torch

from metrics_tpu_torch.functional.text.chrf import _chrf_check_args, _chrf_score_compute, _chrf_score_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat


class CHRFScore(Metric):
    """Streaming corpus chrF/chrF++: six per-order sums, counted and summed on
    the host (:meth:`Metric._host_accumulate`); with
    ``return_sentence_level_score`` also the ``sentence_chrf_score`` cat state.

    Example:
        >>> from metrics_tpu_torch import CHRFScore
        >>> metric = CHRFScore(device="cpu")
        >>> metric.update(['the cat is on the mat'], [['there is a cat on the mat', 'a cat is on the mat']])
        >>> round(float(metric.compute()), 4)
        0.864
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True

    def __init__(
        self,
        n_char_order: int = 6,
        n_word_order: int = 2,
        beta: float = 2.0,
        lowercase: bool = False,
        whitespace: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _chrf_check_args(n_char_order, n_word_order, beta)
        self.n_char_order = n_char_order
        self.n_word_order = n_word_order
        self.beta = beta
        self.lowercase = lowercase
        self.whitespace = whitespace
        self.return_sentence_level_score = return_sentence_level_score
        self.n_order = float(n_char_order + n_word_order)
        for side in ("preds", "target", "matching"):
            self.add_state(f"{side}_char", default=torch.zeros(n_char_order), dist_reduce_fx="sum")
            self.add_state(f"{side}_word", default=torch.zeros(n_word_order), dist_reduce_fx="sum")
        if return_sentence_level_score:
            self.add_state("sentence_chrf_score", default=[], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        preds_ = [preds] if isinstance(preds, str) else list(preds)
        target_ = [[t] if isinstance(t, str) else list(t) for t in target]
        if len(preds_) != len(target_):
            raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
        scores = [] if self.return_sentence_level_score else None
        p_char, p_word, t_char, t_word, m_char, m_word = _chrf_score_update(
            preds_, target_, self.n_char_order, self.n_word_order, self.beta, self.lowercase, self.whitespace, scores
        )
        self._host_accumulate(
            preds_char=p_char, preds_word=p_word, target_char=t_char,
            target_word=t_word, matching_char=m_char, matching_word=m_word,
        )
        if self.return_sentence_level_score:
            self._append_list_state(
                "sentence_chrf_score", torch.tensor(scores, dtype=torch.float32, device=self._list_device)
            )

    def compute(self) -> Union[torch.Tensor, tuple]:
        score = _chrf_score_compute(
            self.preds_char, self.preds_word, self.target_char, self.target_word,
            self.matching_char, self.matching_word, self.n_order, self.beta,
        )
        if self.return_sentence_level_score:
            return score, dim_zero_cat(self.sentence_chrf_score)
        return score
