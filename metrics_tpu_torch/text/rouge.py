"""ROUGEScore (counterpart of ``metrics_tpu/text/rouge.py``)."""

from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.text.rouge import (
    ALLOWED_ROUGE_KEYS,
    _make_stemmer,
    _rouge_check_args,
    _rouge_normalize_inputs,
    _rouge_score_update,
)
from metrics_tpu_torch.metric import Metric


class ROUGEScore(Metric):
    """Streaming ROUGE: per-(key, stat) sums ``rouge{key}_{stat}_sum`` and a
    shared count ``total``, summed on the host (:meth:`Metric._host_accumulate`).

    Example:
        >>> from metrics_tpu_torch import ROUGEScore
        >>> metric = ROUGEScore(rouge_keys=('rouge1',), device="cpu")
        >>> metric.update(['the cat sat on the mat'], ['a cat sat on the mat'])
        >>> round(float(metric.compute()['rouge1_fmeasure']), 6)
        0.833333
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        use_stemmer: bool = False,
        normalizer: Optional[Callable[[str], str]] = None,
        tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
        accumulate: str = "best",
        rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.rouge_keys = _rouge_check_args(accumulate, rouge_keys)
        self.rouge_keys_values = [ALLOWED_ROUGE_KEYS[k] for k in self.rouge_keys]
        self.stemmer = _make_stemmer() if use_stemmer else None
        self.normalizer = normalizer
        self.tokenizer = tokenizer
        self.accumulate = accumulate
        for key in self.rouge_keys_values:
            for stat in ("fmeasure", "precision", "recall"):
                self.add_state(f"rouge{key}_{stat}_sum", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(
        self,
        preds: Union[str, Sequence[str]],
        target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    ) -> None:
        preds, target = _rouge_normalize_inputs(preds, target)
        stats = _rouge_score_update(
            preds, target, self.rouge_keys_values, self.accumulate, self.stemmer, self.normalizer, self.tokenizer
        )
        inc = {}
        n = 0
        for key, per_stat in stats.items():
            for stat, (total, count) in per_stat.items():
                inc[f"rouge{key}_{stat}_sum"] = total
                n = count
        inc["total"] = n
        self._host_accumulate(**inc)

    def compute(self) -> Dict[str, torch.Tensor]:
        denom = torch.clamp_min(self.total, 1.0)
        return {
            f"rouge{key}_{stat}": getattr(self, f"rouge{key}_{stat}_sum") / denom
            for key in self.rouge_keys_values
            for stat in ("fmeasure", "precision", "recall")
        }
