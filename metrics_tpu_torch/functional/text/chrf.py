"""chrF and chrF++ (counterpart of ``metrics_tpu/functional/text/chrf.py``).

The per-order statistics are ``(n_char_order,)`` and ``(n_word_order,)``
sums, counted on the host; the corpus score is tensor math on the device of
the sums.  A sentence's score is numpy float64, as in the JAX package.
"""

import string
from collections import Counter
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

_EPS = 1e-16
_PUNCTUATIONS = set(string.punctuation)


def _characters(sentence: str, whitespace: bool) -> List[str]:
    if whitespace:
        return list(sentence)
    return list(sentence.strip().replace(" ", ""))


def _words_and_punctuation(sentence: str) -> List[str]:
    """Split words, peeling a single leading/trailing punctuation char off."""
    out: List[str] = []
    for word in sentence.strip().split():
        if len(word) == 1:
            out.append(word)
        elif word[-1] in _PUNCTUATIONS:
            out.extend([word[:-1], word[-1]])
        elif word[0] in _PUNCTUATIONS:
            out.extend([word[0], word[1:]])
        else:
            out.append(word)
    return out


def _ngram_counts(tokens: List[str], max_order: int) -> List[Counter]:
    """Counters for n = 1..max_order (index n-1)."""
    return [
        Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))
        for n in range(1, max_order + 1)
    ]


def _sentence_stats(
    sentence: str, n_char_order: int, n_word_order: int, lowercase: bool, whitespace: bool
) -> Tuple[List[Counter], List[Counter], np.ndarray, np.ndarray]:
    if lowercase:
        sentence = sentence.lower()
    char_counts = _ngram_counts(_characters(sentence, whitespace), n_char_order)
    word_counts = _ngram_counts(_words_and_punctuation(sentence), n_word_order)
    char_totals = np.asarray([sum(c.values()) for c in char_counts], dtype=np.float64)
    word_totals = np.asarray([sum(c.values()) for c in word_counts], dtype=np.float64)
    return char_counts, word_counts, char_totals, word_totals


def _matches(hyp: List[Counter], ref: List[Counter]) -> np.ndarray:
    return np.asarray(
        [sum((h & r).values()) for h, r in zip(hyp, ref)], dtype=np.float64
    )


def _fscore(
    matching_char: np.ndarray, matching_word: np.ndarray,
    hyp_char: np.ndarray, hyp_word: np.ndarray,
    ref_char: np.ndarray, ref_word: np.ndarray,
    n_order: float, beta: float,
) -> float:
    def per_order(matching, ref, hyp):
        precision = np.where(hyp > 0, matching / np.maximum(hyp, 1e-300), 0.0)
        recall = np.where(ref > 0, matching / np.maximum(ref, 1e-300), 0.0)
        denom = np.maximum(beta**2 * precision + recall, _EPS)
        return (1 + beta**2) * precision * recall / denom

    total = per_order(matching_char, ref_char, hyp_char).sum()
    total += per_order(matching_word, ref_word, hyp_word).sum()
    return float(total / n_order)


def _chrf_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_char_order: int,
    n_word_order: int,
    beta: float,
    lowercase: bool,
    whitespace: bool,
    sentence_scores: Optional[List[float]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-batch corpus statistics; best-matching reference per hypothesis.

    Returns (preds_char, preds_word, target_char, target_word, matching_char,
    matching_word) arrays of per-order totals.
    """
    n_order = float(n_char_order + n_word_order)
    tot_p_char = np.zeros(n_char_order)
    tot_p_word = np.zeros(n_word_order)
    tot_t_char = np.zeros(n_char_order)
    tot_t_word = np.zeros(n_word_order)
    tot_m_char = np.zeros(n_char_order)
    tot_m_word = np.zeros(n_word_order)

    for pred, refs in zip(preds, target):
        h_char, h_word, h_char_tot, h_word_tot = _sentence_stats(
            pred, n_char_order, n_word_order, lowercase, whitespace
        )
        best = None
        best_f = -1.0
        for ref in refs:
            r_char, r_word, r_char_tot, r_word_tot = _sentence_stats(
                ref, n_char_order, n_word_order, lowercase, whitespace
            )
            m_char = _matches(h_char, r_char)
            m_word = _matches(h_word, r_word)
            f = _fscore(m_char, m_word, h_char_tot, h_word_tot, r_char_tot, r_word_tot, n_order, beta)
            if f > best_f:
                best_f = f
                best = (r_char_tot, r_word_tot, m_char, m_word)
        assert best is not None, "each hypothesis needs at least one reference"
        r_char_tot, r_word_tot, m_char, m_word = best
        tot_p_char += h_char_tot
        tot_p_word += h_word_tot
        tot_t_char += r_char_tot
        tot_t_word += r_word_tot
        tot_m_char += m_char
        tot_m_word += m_word
        if sentence_scores is not None:
            sentence_scores.append(best_f)
    return tot_p_char, tot_p_word, tot_t_char, tot_t_word, tot_m_char, tot_m_word


def _chrf_score_compute(
    preds_char: torch.Tensor,
    preds_word: torch.Tensor,
    target_char: torch.Tensor,
    target_word: torch.Tensor,
    matching_char: torch.Tensor,
    matching_word: torch.Tensor,
    n_order: float,
    beta: float,
) -> torch.Tensor:
    """Corpus chrF from the per-order totals."""

    def per_order(matching, ref, hyp):
        # the floor 1e-300 is 0 in float32, as ``jnp.maximum`` casts it
        precision = torch.where(hyp > 0, matching / torch.clamp_min(hyp, 1e-300), 0.0)
        recall = torch.where(ref > 0, matching / torch.clamp_min(ref, 1e-300), 0.0)
        denom = torch.clamp_min(beta**2 * precision + recall, _EPS)
        return (1 + beta**2) * precision * recall / denom

    total = per_order(matching_char, target_char, preds_char).sum()
    total = total + per_order(matching_word, target_word, preds_word).sum()
    return total / n_order


def chrf_score(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    n_char_order: int = 6,
    n_word_order: int = 2,
    beta: float = 2.0,
    lowercase: bool = False,
    whitespace: bool = False,
    return_sentence_level_score: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """chrF (``n_word_order=0``) or chrF++ (``n_word_order=2``), float32 CPU tensors.

    Example:
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> round(float(chrf_score(preds, target)), 4)
        0.864
    """
    _chrf_check_args(n_char_order, n_word_order, beta)
    preds_ = [preds] if isinstance(preds, str) else list(preds)
    target_ = [[t] if isinstance(t, str) else list(t) for t in target]
    if len(preds_) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
    sentence_scores: Optional[List[float]] = [] if return_sentence_level_score else None
    stats = _chrf_score_update(
        preds_, target_, n_char_order, n_word_order, beta, lowercase, whitespace, sentence_scores
    )
    n_order = float(n_char_order + n_word_order)
    score = _chrf_score_compute(*[torch.as_tensor(np.asarray(s, np.float32)) for s in stats], n_order, beta)
    if return_sentence_level_score:
        return score, torch.tensor(sentence_scores, dtype=torch.float32)
    return score


def _chrf_check_args(n_char_order: int, n_word_order: int, beta: float) -> None:
    if not isinstance(n_char_order, int) or n_char_order < 1:
        raise ValueError("Expected `n_char_order` to be an integer greater than or equal to 1.")
    if not isinstance(n_word_order, int) or n_word_order < 0:
        raise ValueError("Expected `n_word_order` to be an integer greater than or equal to 0.")
    if beta < 0:
        raise ValueError("Expected `beta` to be greater than 0.")
