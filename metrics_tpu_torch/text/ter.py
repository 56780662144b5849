"""TranslationEditRate (counterpart of ``metrics_tpu/text/ter.py``)."""

from typing import Any, Sequence, Union

import torch

from metrics_tpu_torch.functional.text.ter import _TercomTokenizer, _ter_compute, _ter_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat


class TranslationEditRate(Metric):
    """Streaming translation edit rate over batches of strings.

    The edit counts and average reference lengths are summed on the host
    (:meth:`Metric._host_accumulate`): an update issues no device operation.
    With ``return_sentence_level_score`` each update also appends its
    sentences' scores to the ``sentence_ter`` cat state.

    Example:
        >>> from metrics_tpu_torch import TranslationEditRate
        >>> metric = TranslationEditRate(device="cpu")
        >>> metric.update(['the cat is on the mat'], [['there is a cat on the mat', 'a cat is on the mat']])
        >>> round(float(metric.compute()), 4)
        0.1538
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
        self.return_sentence_level_score = return_sentence_level_score
        self.add_state("total_num_edits", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total_tgt_length", default=torch.tensor(0.0), dist_reduce_fx="sum")
        if return_sentence_level_score:
            self.add_state("sentence_ter", default=[], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        scores = [] if self.return_sentence_level_score else None
        num_edits, tgt_length = _ter_update(preds, target, self.tokenizer, scores)
        self._host_accumulate(total_num_edits=num_edits, total_tgt_length=tgt_length)
        if self.return_sentence_level_score:
            self._append_list_state("sentence_ter", torch.tensor(scores, dtype=torch.float32, device=self._list_device))

    def compute(self) -> Union[torch.Tensor, tuple]:
        score = _ter_compute(self.total_num_edits, self.total_tgt_length)
        if self.return_sentence_level_score:
            return score, dim_zero_cat(self.sentence_ter)
        return score
