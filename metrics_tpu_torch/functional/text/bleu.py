"""BLEU score (counterpart of ``metrics_tpu/functional/text/bleu.py``).

The n-grams are counted on the host into ``(n_gram,)`` numerator and
denominator sums; the score is tensor math on the device of the sums.  When
two references are equally close in length, the shorter one sets the brevity
penalty (the mteval, sacrebleu and NLTK convention), as in the JAX package.
"""

from collections import Counter
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch


def _bleu_normalize_inputs(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    n_gram: int,
    weights: Optional[Sequence[float]],
) -> Tuple[Sequence[str], Sequence[Sequence[str]], Sequence[float]]:
    """Shared normalization and validation for every BLEU entry point."""
    preds_ = [preds] if isinstance(preds, str) else list(preds)
    target_ = [[t] if isinstance(t, str) else list(t) for t in target]
    if len(preds_) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
    if weights is not None and len(weights) != n_gram:
        raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
    return preds_, target_, list(weights) if weights is not None else [1.0 / n_gram] * n_gram


def _count_ngram(tokens: Sequence[str], n_gram: int) -> Counter:
    counter: Counter = Counter()
    for n in range(1, n_gram + 1):
        for j in range(len(tokens) - n + 1):
            counter[tuple(tokens[j : j + n])] += 1
    return counter


def _tokenize_fn(sentence: str) -> Sequence[str]:
    return sentence.split()


def _bleu_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    tokenizer: Callable[[str], Sequence[str]] = _tokenize_fn,
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Clipped n-gram matches of the batch: ``(n_gram,)`` numerator and
    denominator, the candidate length and the closest references' length."""
    numerator = np.zeros(n_gram)
    denominator = np.zeros(n_gram)
    preds_len = 0
    target_len = 0
    tgt_tok = [[tokenizer(line) if line else [] for line in t] for t in target]
    prd_tok = [tokenizer(line) if line else [] for line in preds]
    for pred, targets in zip(prd_tok, tgt_tok):
        preds_len += len(pred)
        tgt_lens = [len(t) for t in targets]
        # closest reference length; ties broken by the shorter reference
        target_len += min(tgt_lens, key=lambda x: (abs(len(pred) - x), x))
        pred_counter = _count_ngram(pred, n_gram)
        tgt_counter: Counter = Counter()
        for t in targets:
            tgt_counter |= _count_ngram(t, n_gram)
        clipped = pred_counter & tgt_counter
        for key, cnt in clipped.items():
            numerator[len(key) - 1] += cnt
        for key, cnt in pred_counter.items():
            denominator[len(key) - 1] += cnt
    return numerator, denominator, preds_len, target_len


def _bleu_score_compute(
    preds_len: torch.Tensor,
    target_len: torch.Tensor,
    numerator: torch.Tensor,
    denominator: torch.Tensor,
    n_gram: int,
    weights: Sequence[float],
    smooth: bool,
) -> torch.Tensor:
    """Geometric mean of the n-gram precisions times the brevity penalty, on the sums' device."""
    if smooth:
        precision = (numerator + 1.0) / (denominator + 1.0)
        precision = torch.cat([(numerator[0] / denominator[0]).reshape(1), precision[1:]])
    else:
        precision = numerator / denominator
    w = torch.tensor(list(weights), dtype=torch.float32, device=numerator.device)
    geometric_mean = torch.exp(torch.sum(w * torch.log(precision)))
    brevity = torch.where(preds_len > target_len, 1.0, torch.exp(1 - target_len / preds_len))
    bleu = brevity * geometric_mean
    return torch.where(torch.min(numerator) == 0.0, 0.0, bleu)


def _as_f32(value, device: Optional[torch.device] = None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(value, np.float32), device=device)


def bleu_score(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    n_gram: int = 4,
    smooth: bool = False,
    weights: Optional[Sequence[float]] = None,
) -> torch.Tensor:
    """BLEU score of translated text against one or more references (a float32 CPU tensor).

    Example:
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> round(float(bleu_score(preds, target)), 4)
        0.7598
    """
    preds_, target_, weights = _bleu_normalize_inputs(preds, target, n_gram, weights)
    numerator, denominator, preds_len, target_len = _bleu_score_update(preds_, target_, n_gram)
    return _bleu_score_compute(
        _as_f32(preds_len), _as_f32(target_len), _as_f32(numerator), _as_f32(denominator), n_gram, weights, smooth
    )
