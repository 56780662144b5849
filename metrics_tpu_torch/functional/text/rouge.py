"""ROUGE (counterpart of ``metrics_tpu/functional/text/rouge.py``).

ROUGE-N (1 to 9), ROUGE-L and ROUGE-Lsum with the google-research
``rouge_scorer`` normalization and the union LCS, as host Python.  The
sentence scores stream into per-(key, stat) sums and one count.
"""

import re
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.utils.imports import _NLTK_AVAILABLE

ALLOWED_ROUGE_KEYS: Dict[str, Union[int, str]] = {
    "rouge1": 1, "rouge2": 2, "rouge3": 3, "rouge4": 4, "rouge5": 5,
    "rouge6": 6, "rouge7": 7, "rouge8": 8, "rouge9": 9,
    "rougeL": "L", "rougeLsum": "Lsum",
}
ALLOWED_ACCUMULATE_VALUES = ("avg", "best")


_NLTK_SPLIT_USABLE: Optional[bool] = None  # probed once, not per sentence


def _split_sentence(x: str) -> Sequence[str]:
    """Sentence-split for ROUGE-LSum: nltk when its data is present, else a
    punctuation/newline regex fallback (keeps the metric dependency-free)."""
    global _NLTK_SPLIT_USABLE
    if _NLTK_SPLIT_USABLE is None:
        try:
            import nltk

            nltk.sent_tokenize("probe. probe.")
            _NLTK_SPLIT_USABLE = True
        except Exception:
            _NLTK_SPLIT_USABLE = False
    if _NLTK_SPLIT_USABLE:
        import nltk

        return nltk.sent_tokenize(x)
    parts = re.split(r"(?:(?<=[.!?])\s+)|\n", x.strip())
    return [p for p in parts if p]


def _stat_triple(hits_or_lcs: int, pred_len: int, target_len: int) -> Dict[str, float]:
    precision = hits_or_lcs / pred_len
    recall = hits_or_lcs / target_len
    if precision == recall == 0.0:
        return dict(precision=0.0, recall=0.0, fmeasure=0.0)
    return dict(
        precision=precision,
        recall=recall,
        fmeasure=2 * precision * recall / (precision + recall),
    )


def _lcs_table(pred: Sequence[str], target: Sequence[str]) -> List[List[int]]:
    """The LCS table, ``table[i][j]`` for ``target[:i]`` and ``pred[:j]`` (the JAX
    package's, built a row at a time without ``max`` calls)."""
    table = [[0] * (len(pred) + 1)]
    for ti in target:
        prev = table[-1]
        left = 0
        row = [0]
        append = row.append
        for pj, diag, up in zip(pred, prev, prev[1:]):
            if ti == pj:
                left = diag + 1
            elif up > left:
                left = up
            append(left)
        table.append(row)
    return table


def _lcs_indices(pred: Sequence[str], target: Sequence[str]) -> List[int]:
    """Target-side indices of one longest common subsequence."""
    table = _lcs_table(pred, target)
    i, j = len(pred), len(target)
    out: List[int] = []
    while i > 0 and j > 0:
        if pred[i - 1] == target[j - 1]:
            out.insert(0, j - 1)
            i -= 1
            j -= 1
        elif table[j][i - 1] > table[j - 1][i]:
            i -= 1
        else:
            j -= 1
    return out


def _normalize_and_tokenize_text(
    text: str,
    stemmer: Optional[Any] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
) -> Sequence[str]:
    """Lowercase alphanumeric tokens, optional Porter stemming of words >3 chars."""
    text = normalizer(text) if callable(normalizer) else re.sub(r"[^a-z0-9]+", " ", text.lower())
    tokens = tokenizer(text) if callable(tokenizer) else re.split(r"\s+", text)
    if stemmer:
        tokens = [stemmer.stem(x) if len(x) > 3 else x for x in tokens]
    return [x for x in tokens if isinstance(x, str) and len(x) > 0]


def _rouge_n_score(pred: Sequence[str], target: Sequence[str], n_gram: int) -> Dict[str, float]:
    def ngrams(tokens: Sequence[str]) -> Counter:
        return Counter(tuple(tokens[i : i + n_gram]) for i in range(len(tokens) - n_gram + 1))

    p, t = ngrams(pred), ngrams(target)
    pred_len, target_len = sum(p.values()), sum(t.values())
    if 0 in (pred_len, target_len):
        return dict(precision=0.0, recall=0.0, fmeasure=0.0)
    # clipped overlap without materializing the Counter intersection
    if len(t) < len(p):
        p, t = t, p
    hits = sum(c if c <= t[k] else t[k] for k, c in p.items() if k in t)
    return _stat_triple(hits, pred_len, target_len)


def _lcs_length(pred: Sequence[str], target: Sequence[str]) -> int:
    """LCS length only — two rolling rows instead of the full table."""
    prev = [0] * (len(pred) + 1)
    cur = [0] * (len(pred) + 1)
    for ti in target:
        for j in range(1, len(pred) + 1):
            if ti == pred[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                a, b = prev[j], cur[j - 1]
                cur[j] = a if a >= b else b
        prev, cur = cur, prev
    return prev[len(pred)]


def _rouge_l_score(pred: Sequence[str], target: Sequence[str]) -> Dict[str, float]:
    if 0 in (len(pred), len(target)):
        return dict(precision=0.0, recall=0.0, fmeasure=0.0)
    lcs = _lcs_length(pred, target)
    return _stat_triple(lcs, len(pred), len(target))


def _rouge_lsum_score(
    pred_sents: Sequence[Sequence[str]], target_sents: Sequence[Sequence[str]]
) -> Dict[str, float]:
    """Summary-level ROUGE-L: union-LCS per target sentence with clipping."""
    pred_len = sum(map(len, pred_sents))
    target_len = sum(map(len, target_sents))
    if 0 in (pred_len, target_len):
        return dict(precision=0.0, recall=0.0, fmeasure=0.0)
    pred_counts = Counter()
    for s in pred_sents:
        pred_counts.update(s)
    target_counts = Counter()
    for s in target_sents:
        target_counts.update(s)
    hits = 0
    for tgt in target_sents:
        union = sorted(set().union(*[set(_lcs_indices(p, tgt)) for p in pred_sents]))
        for idx in union:
            token = tgt[idx]
            if pred_counts[token] > 0 and target_counts[token] > 0:
                hits += 1
                pred_counts[token] -= 1
                target_counts[token] -= 1
    return _stat_triple(hits, pred_len, target_len)


def _rouge_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    rouge_keys_values: List[Union[int, str]],
    accumulate: str,
    stemmer: Optional[Any] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
) -> Dict[Union[int, str], Dict[str, Tuple[float, int]]]:
    """Per-key (sum of stat, count) over the batch.

    Multi-reference handling per ``accumulate``: ``best`` keeps the reference
    with the highest first-key fmeasure, ``avg`` averages over references.
    """
    totals: Dict[Union[int, str], Dict[str, List[float]]] = {
        k: {"precision": [], "recall": [], "fmeasure": []} for k in rouge_keys_values
    }
    need_lsum = "Lsum" in rouge_keys_values
    for pred_raw, refs in zip(preds, target):
        pred = _normalize_and_tokenize_text(pred_raw, stemmer, normalizer, tokenizer)
        pred_lsum = [
            _normalize_and_tokenize_text(s, stemmer, normalizer, tokenizer)
            for s in _split_sentence(pred_raw)
        ] if need_lsum else []
        per_ref: List[Dict[Union[int, str], Dict[str, float]]] = []
        for ref_raw in refs:
            tgt = _normalize_and_tokenize_text(ref_raw, stemmer, normalizer, tokenizer)
            scores: Dict[Union[int, str], Dict[str, float]] = {}
            for key in rouge_keys_values:
                if isinstance(key, int):
                    scores[key] = _rouge_n_score(pred, tgt, key)
                elif key == "L":
                    scores[key] = _rouge_l_score(pred, tgt)
                else:  # Lsum
                    tgt_lsum = [
                        _normalize_and_tokenize_text(s, stemmer, normalizer, tokenizer)
                        for s in _split_sentence(ref_raw)
                    ]
                    scores[key] = _rouge_lsum_score(pred_lsum, tgt_lsum)
            per_ref.append(scores)
        if accumulate == "best":
            first = rouge_keys_values[0]
            best = max(range(len(per_ref)), key=lambda i: per_ref[i][first]["fmeasure"])
            chosen = per_ref[best]
            for key in rouge_keys_values:
                for stat in ("precision", "recall", "fmeasure"):
                    totals[key][stat].append(chosen[key][stat])
        else:  # avg
            for key in rouge_keys_values:
                for stat in ("precision", "recall", "fmeasure"):
                    vals = [r[key][stat] for r in per_ref]
                    totals[key][stat].append(sum(vals) / len(vals))
    return {
        k: {stat: (sum(v), len(v)) for stat, v in stats.items()}
        for k, stats in totals.items()
    }


def _rouge_check_args(accumulate: str, rouge_keys: Union[str, Tuple[str, ...]]) -> Tuple[str, ...]:
    if accumulate not in ALLOWED_ACCUMULATE_VALUES:
        raise ValueError(
            f"Got unknown accumulate value {accumulate}. Expected to be one of {ALLOWED_ACCUMULATE_VALUES}"
        )
    if isinstance(rouge_keys, str):
        rouge_keys = (rouge_keys,)
    for key in rouge_keys:
        if key not in ALLOWED_ROUGE_KEYS:
            raise ValueError(f"Got unknown rouge key {key}. Expected to be one of {list(ALLOWED_ROUGE_KEYS)}")
    return tuple(rouge_keys)


def _rouge_normalize_inputs(preds, target):
    if isinstance(target, list) and all(isinstance(t, str) for t in target):
        target = [target] if isinstance(preds, str) else [[t] for t in target]
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [[target]]
    return preds, target


def rouge_score(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    accumulate: str = "best",
    use_stemmer: bool = False,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
    rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
) -> Dict[str, torch.Tensor]:
    """ROUGE-N/L/Lsum precision, recall and F1 per requested key (float32 CPU tensors).

    Example:
        >>> preds = "My name is John"
        >>> target = "Is your name John"
        >>> scores = rouge_score(preds, target)
        >>> round(float(scores["rouge1_fmeasure"]), 4)
        0.75
    """
    rouge_keys = _rouge_check_args(accumulate, rouge_keys)
    stemmer = _make_stemmer() if use_stemmer else None
    rouge_keys_values = [ALLOWED_ROUGE_KEYS[k] for k in rouge_keys]
    preds, target = _rouge_normalize_inputs(preds, target)
    stats = _rouge_score_update(preds, target, rouge_keys_values, accumulate, stemmer, normalizer, tokenizer)
    out: Dict[str, torch.Tensor] = {}
    for key, per_stat in stats.items():
        for stat, (total, count) in per_stat.items():
            out[f"rouge{key}_{stat}"] = torch.as_tensor(
                np.float32(total) / np.float32(max(count, 1)) if count > 0 else np.float32(0.0)
            )
    return out


def _make_stemmer():
    """Porter stemmer (pure algorithm, no corpus data needed); needs ``nltk``."""
    if not _NLTK_AVAILABLE:
        raise ModuleNotFoundError("Stemmer requires the `nltk` package to be installed.")
    from nltk.stem.porter import PorterStemmer

    return PorterStemmer()
