"""ExtendedEditDistance (counterpart of ``metrics_tpu/text/eed.py``)."""

from typing import Any, Sequence, Union

import torch

from metrics_tpu_torch.functional.text.eed import _eed_compute, _eed_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat


class ExtendedEditDistance(Metric):
    """Streaming extended edit distance: the sentence scores' sum and count,
    summed on the host (:meth:`Metric._host_accumulate`); with
    ``return_sentence_level_score`` also the ``sentence_eed`` cat state.

    Example:
        >>> from metrics_tpu_torch import ExtendedEditDistance
        >>> metric = ExtendedEditDistance(device="cpu")
        >>> metric.update(["this is the prediction", "here is an other sample"],
        ...               ["this is the reference", "here is another one"])
        >>> round(float(metric.compute()), 4)
        0.3078
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        language: str = "en",
        return_sentence_level_score: bool = False,
        alpha: float = 2.0,
        rho: float = 0.3,
        deletion: float = 0.2,
        insertion: float = 1.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if language not in ("en", "ja"):
            raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
        self.language = language
        self.return_sentence_level_score = return_sentence_level_score
        self.alpha = alpha
        self.rho = rho
        self.deletion = deletion
        self.insertion = insertion
        self.add_state("score_sum", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("score_count", default=torch.tensor(0.0), dist_reduce_fx="sum")
        if return_sentence_level_score:
            self.add_state("sentence_eed", default=[], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        scores = [] if self.return_sentence_level_score else None
        total, count = _eed_update(
            preds, target, self.language, self.alpha, self.rho, self.deletion, self.insertion, scores
        )
        self._host_accumulate(score_sum=total, score_count=count)
        if self.return_sentence_level_score:
            self._append_list_state("sentence_eed", torch.tensor(scores, dtype=torch.float32, device=self._list_device))

    def compute(self) -> Union[torch.Tensor, tuple]:
        score = _eed_compute(self.score_sum, self.score_count)
        if self.return_sentence_level_score:
            return score, dim_zero_cat(self.sentence_eed)
        return score
