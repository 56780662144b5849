"""Translation edit rate (counterpart of ``metrics_tpu/functional/text/ter.py``).

TER counts the fewest edits (insertions, deletions, substitutions and
phrase shifts) that turn a hypothesis into a reference, over the average
reference length.  The Tercom tokenizer, the greedy shift search and the
trace alignment are host Python, as in the JAX package; an update's sums
wait on the host (:meth:`Metric._host_accumulate`).
"""

import re
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.functional.text.helper import _validate_inputs

_MAX_SHIFT_SIZE = 10
_MAX_SHIFT_DIST = 50
_MAX_SHIFT_CANDIDATES = 1000

# trace op codes: hypothesis is rewritten into the reference
_NOP, _SUB, _INS, _DEL = " ", "s", "i", "d"


class _TercomTokenizer:
    """Tercom normalization (Normalizer.java semantics): lowercasing,
    punctuation tokenization, optional punctuation removal, CJK splitting."""

    _ASIAN_PUNCT = r"([、。〈-】〔-〟｡-･・])"
    _FULL_WIDTH_PUNCT = r"([．，？：；！＂（）])"

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
    ) -> None:
        self.normalize = normalize
        self.no_punctuation = no_punctuation
        self.lowercase = lowercase
        self.asian_support = asian_support

    def __call__(self, sentence: str) -> str:
        if not sentence:
            return ""
        if self.lowercase:
            sentence = sentence.lower()
        if self.normalize:
            sentence = self._normalize_western(sentence)
            if self.asian_support:
                sentence = self._normalize_asian(sentence)
        if self.no_punctuation:
            sentence = re.sub(r"[\.,\?:;!\"\(\)]", "", sentence)
            if self.asian_support:
                sentence = re.sub(self._ASIAN_PUNCT, "", sentence)
                sentence = re.sub(self._FULL_WIDTH_PUNCT, "", sentence)
        return " ".join(sentence.split())

    @staticmethod
    def _normalize_western(sent: str) -> str:
        sent = re.sub(r"\n-", "", sent)
        sent = re.sub(r"\n", " ", sent)
        for esc, ch in (("&quot;", '"'), ("&amp;", "&"), ("&lt;", "<"), ("&gt;", ">")):
            sent = sent.replace(esc, ch)
        sent = f" {sent} "
        sent = re.sub(r"([{-~[-` -&(-+:-@/])", r" \1 ", sent)
        sent = re.sub(r"'s ", r" 's ", sent)
        sent = re.sub(r"'s$", r" 's", sent)
        sent = re.sub(r"([^0-9])([\.,])", r"\1 \2 ", sent)
        sent = re.sub(r"([\.,])([^0-9])", r" \1 \2", sent)
        sent = re.sub(r"([0-9])(-)", r"\1 \2 ", sent)
        return sent

    @classmethod
    def _normalize_asian(cls, sent: str) -> str:
        sent = re.sub(r"([一-鿿㐀-䶿])", r" \1 ", sent)
        sent = re.sub(r"([㇀-㇯⺀-⻿])", r" \1 ", sent)
        sent = re.sub(r"([㌀-㏿豈-﫿︰-﹏])", r" \1 ", sent)
        sent = re.sub(r"([㈀-㼢])", r" \1 ", sent)
        sent = re.sub(cls._ASIAN_PUNCT, r" \1 ", sent)
        sent = re.sub(cls._FULL_WIDTH_PUNCT, r" \1 ", sent)
        return sent


def _edit_distance_with_trace(hyp: List[str], ref: List[str]) -> Tuple[int, str]:
    """Levenshtein distance plus the op trace, tercom tie-breaking.

    Op preference (strict-improvement updates): match/substitute, then
    hyp-consuming delete, then ref-consuming insert — the ordering tercom uses
    once the trace is read hypothesis→reference.
    """
    nh, nr = len(hyp), len(ref)
    INF = 1 << 60
    # dist[i][j] = (cost, op) for hyp[:i] -> ref[:j]
    dist = [[(INF, "x")] * (nr + 1) for _ in range(nh + 1)]
    dist[0][0] = (0, _NOP)
    for j in range(1, nr + 1):
        dist[0][j] = (j, _INS)
    for i in range(1, nh + 1):
        dist[i][0] = (i, _DEL)
        hi = hyp[i - 1]
        row, prev = dist[i], dist[i - 1]
        for j in range(1, nr + 1):
            if hi == ref[j - 1]:
                cost_sub, op_sub = prev[j - 1][0], _NOP
            else:
                cost_sub, op_sub = prev[j - 1][0] + 1, _SUB
            best, op = cost_sub, op_sub
            c = prev[j][0] + 1
            if c < best:
                best, op = c, _DEL
            c = row[j - 1][0] + 1
            if c < best:
                best, op = c, _INS
            row[j] = (best, op)
    trace = []
    i, j = nh, nr
    while i > 0 or j > 0:
        op = dist[i][j][1]
        trace.append(op)
        if op in (_NOP, _SUB):
            i -= 1
            j -= 1
        elif op == _INS:
            j -= 1
        else:
            i -= 1
    return dist[nh][nr][0], "".join(reversed(trace))


def _trace_to_alignment(trace: str) -> Tuple[Dict[int, int], List[int], List[int]]:
    """Map each reference position to its aligned hypothesis position and flag
    erroneous positions on both sides."""
    pos_hyp = pos_ref = -1
    hyp_err: List[int] = []
    ref_err: List[int] = []
    align: Dict[int, int] = {}
    for op in trace:
        if op == _NOP:
            pos_hyp += 1
            pos_ref += 1
            align[pos_ref] = pos_hyp
            hyp_err.append(0)
            ref_err.append(0)
        elif op == _SUB:
            pos_hyp += 1
            pos_ref += 1
            align[pos_ref] = pos_hyp
            hyp_err.append(1)
            ref_err.append(1)
        elif op == _DEL:
            pos_hyp += 1
            hyp_err.append(1)
        else:  # _INS
            pos_ref += 1
            align[pos_ref] = pos_hyp
            ref_err.append(1)
    return align, ref_err, hyp_err


def _matching_spans(hyp: List[str], ref: List[str]):
    """Yield (start_h, start_r, length) for every matching sub-phrase, bounded
    by the tercom span-size/distance limits."""
    for start_h in range(len(hyp)):
        for start_r in range(len(ref)):
            if abs(start_r - start_h) > _MAX_SHIFT_DIST:
                continue
            length = 0
            while hyp[start_h + length] == ref[start_r + length] and length < _MAX_SHIFT_SIZE:
                length += 1
                yield start_h, start_r, length
                if start_h + length == len(hyp) or start_r + length == len(ref):
                    break


def _apply_shift(words: List[str], start: int, length: int, target: int) -> List[str]:
    if target < start:
        return words[:target] + words[start : start + length] + words[target:start] + words[start + length :]
    if target > start + length:
        return words[:start] + words[start + length : target] + words[start : start + length] + words[target:]
    return words[:start] + words[start + length : length + target] + words[start : start + length] + words[length + target :]


def _best_shift(
    hyp: List[str], ref: List[str], checked: int
) -> Tuple[int, List[str], int]:
    """One round of the greedy shift search: try every eligible phrase shift
    and return the one with the largest edit-distance reduction."""
    pre_score, trace = _edit_distance_with_trace(hyp, ref)
    align, ref_err, hyp_err = _trace_to_alignment(trace)
    best = None
    for start_h, start_r, length in _matching_spans(hyp, ref):
        # only shift phrases that are misplaced on both sides
        if sum(hyp_err[start_h : start_h + length]) == 0:
            continue
        if sum(ref_err[start_r : start_r + length]) == 0:
            continue
        if start_h <= align[start_r] < start_h + length:
            continue
        prev_idx = -1
        for offset in range(-1, length):
            if start_r + offset == -1:
                idx = 0
            elif start_r + offset in align:
                idx = align[start_r + offset] + 1
            else:
                break
            if idx == prev_idx:
                continue
            prev_idx = idx
            shifted = _apply_shift(hyp, start_h, length, idx)
            candidate = (
                pre_score - _edit_distance_with_trace(shifted, ref)[0],
                length,
                -start_h,
                -idx,
                shifted,
            )
            checked += 1
            if best is None or candidate > best:
                best = candidate
        if checked >= _MAX_SHIFT_CANDIDATES:
            break
    if best is None:
        return 0, hyp, checked
    return best[0], best[4], checked


def _sentence_ter_statistics(hyp: List[str], ref: List[str]) -> Tuple[int, int]:
    """(num_edits, ref_length) for one hypothesis/reference pair."""
    if not ref:
        return len(hyp), 0
    shifts = 0
    checked = 0
    words = hyp
    while True:
        delta, new_words, checked = _best_shift(words, ref, checked)
        if checked >= _MAX_SHIFT_CANDIDATES or delta <= 0:
            break
        shifts += 1
        words = new_words
    edit_distance, _ = _edit_distance_with_trace(words, ref)
    return shifts + edit_distance, len(ref)


def _compute_sentence_statistics(
    pred_words: List[str], target_words: List[List[str]]
) -> Tuple[float, float]:
    """Best (fewest-edit) reference; denominator is the average ref length."""
    ref_lengths = 0.0
    best_num_edits = float("inf")
    for ref in target_words:
        num_edits, ref_len = _sentence_ter_statistics(pred_words, ref)
        ref_lengths += ref_len
        if num_edits < best_num_edits:
            best_num_edits = num_edits
    return best_num_edits, ref_lengths / len(target_words)


def _ter_score_from_statistics(num_edits, tgt_length) -> torch.Tensor:
    num_edits = torch.as_tensor(num_edits, dtype=torch.float32)
    tgt_length = torch.as_tensor(tgt_length, dtype=torch.float32, device=num_edits.device)
    return torch.where(
        tgt_length > 0,
        num_edits / torch.clamp_min(tgt_length, 1e-30),
        torch.where(num_edits > 0, 1.0, 0.0),
    )


def _sentence_ter_score(num_edits: float, tgt_length: float) -> float:
    """One sentence's TER in float32 on the host (the float32 quotient is the device's)."""
    if tgt_length > 0:
        return float(np.float32(num_edits) / np.float32(tgt_length))
    return 1.0 if num_edits > 0 else 0.0


def _ter_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    tokenizer: _TercomTokenizer,
    sentence_ter: Optional[List[float]] = None,
) -> Tuple[float, float]:
    """Batch totals of (num_edits, avg target length)."""
    target, preds = _validate_inputs(target, preds)
    total_edits = 0.0
    total_length = 0.0
    for pred, tgt in zip(preds, target):
        tgt_words = [tokenizer(t).split() for t in tgt]
        pred_words = tokenizer(pred).split()
        num_edits, tgt_length = _compute_sentence_statistics(pred_words, tgt_words)
        total_edits += num_edits
        total_length += tgt_length
        if sentence_ter is not None:
            sentence_ter.append(_sentence_ter_score(num_edits, tgt_length))
    return total_edits, total_length


def _ter_compute(total_num_edits, total_tgt_length) -> torch.Tensor:
    return _ter_score_from_statistics(total_num_edits, total_tgt_length)


def translation_edit_rate(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    normalize: bool = False,
    no_punctuation: bool = False,
    lowercase: bool = True,
    asian_support: bool = False,
    return_sentence_level_score: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Translation edit rate with the Tercom shift heuristics (float32 CPU tensors).

    Example:
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> round(float(translation_edit_rate(preds, target)), 4)
        0.1538
    """
    tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
    sentence_ter: Optional[List[float]] = [] if return_sentence_level_score else None
    total_edits, total_length = _ter_update(preds, target, tokenizer, sentence_ter)
    score = _ter_compute(total_edits, total_length)
    if sentence_ter is not None:
        return score, torch.tensor(sentence_ter, dtype=torch.float32)
    return score
