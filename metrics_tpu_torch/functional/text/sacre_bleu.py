"""SacreBLEU: BLEU with the standard WMT tokenizers (counterpart of
``metrics_tpu/functional/text/sacre_bleu.py``).

First-party implementations of the mteval tokenizers (``13a``, ``intl``,
``char``, ``zh``, ``none``), as in the JAX package: ``intl`` reads Unicode
categories through :mod:`unicodedata` and needs no ``regex`` package.
"""

import re
import unicodedata
from functools import lru_cache
from typing import Optional, Sequence

import torch

from metrics_tpu_torch.functional.text.bleu import (
    _as_f32,
    _bleu_normalize_inputs,
    _bleu_score_compute,
    _bleu_score_update,
)

AVAILABLE_TOKENIZERS = ("none", "13a", "zh", "intl", "char")

# Unicode codepoint ranges treated as "Chinese characters" by the WMT zh
# tokenizer (CJK ideographs, radicals, kana, hangul, fullwidth forms, ...).
_UCODE_RANGES = (
    (0x3400, 0x4DB5),   # CJK Unified Ideographs Extension A
    (0x4E00, 0x9FA5),   # CJK Unified Ideographs
    (0x9FA6, 0x9FBB),
    (0xF900, 0xFA2D),   # CJK Compatibility Ideographs
    (0xFA30, 0xFA6A),
    (0xFA70, 0xFAD9),
    (0x20000, 0x2A6D6),  # CJK Extension B
    (0x2F800, 0x2FA1D),  # CJK Compatibility Supplement
    (0xFF00, 0xFFEF),   # Full-width ASCII
    (0x2E80, 0x2EFF),   # CJK Radicals
    (0x3000, 0x303F),   # CJK punctuation
    (0x31C0, 0x31EF),   # CJK strokes
    (0x2F00, 0x2FDF),   # Kangxi Radicals
    (0x2FF0, 0x2FFF),   # Ideographic Description Characters
    (0x3100, 0x312F),   # Bopomofo
    (0x31A0, 0x31BF),
    (0xFE10, 0xFE1F),
    (0xFE30, 0xFE4F),
    (0x3040, 0x309F),   # Hiragana
    (0x30A0, 0x30FF),   # Katakana
    (0x31F0, 0x31FF),
    (0x32D0, 0x32FE),
    (0x3200, 0x32FF),   # CJK Enclosed Letters and Months
    (0x3300, 0x33FF),   # CJK Compatibility
    (0xAC00, 0xD7AF),   # Hangul Syllables
)


class _SacreBLEUTokenizer:
    """The five standard WMT tokenizers behind a single dispatch."""

    _REGEX_13A = (
        (re.compile(r"<skipped>"), ""),
        (re.compile(r"-\n"), ""),
        (re.compile(r"\n"), " "),
    )
    _REGEX_13A_TOK = (
        (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
        (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
        (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
        (re.compile(r"([0-9])(-)"), r"\1 \2 "),
    )

    def __init__(self, tokenize: str = "13a", lowercase: bool = False) -> None:
        if tokenize not in AVAILABLE_TOKENIZERS:
            raise ValueError(f"Unsupported tokenizer {tokenize!r}; pick from {AVAILABLE_TOKENIZERS}")
        self.tokenize = tokenize
        self.lowercase = lowercase

    def __call__(self, line: str) -> Sequence[str]:
        tokenized = getattr(self, f"_tokenize_{self.tokenize}")(line)
        if self.lowercase:
            tokenized = [t.lower() for t in tokenized]
        return tokenized

    @classmethod
    def _tokenize_none(cls, line: str) -> Sequence[str]:
        return line.strip().split()

    @classmethod
    def _tokenize_13a(cls, line: str) -> Sequence[str]:
        for pat, repl in cls._REGEX_13A:
            line = pat.sub(repl, line)
        line = line.replace("&quot;", '"').replace("&amp;", "&").replace("&lt;", "<").replace("&gt;", ">")
        if " " in line:
            line = f" {line} "
            for pat, repl in cls._REGEX_13A_TOK:
                line = pat.sub(repl, line)
        return line.strip().split()

    @classmethod
    def _tokenize_intl(cls, line: str) -> Sequence[str]:
        """mteval-v14 international tokenization.

        Symbols always become their own token; punctuation is split off
        unless it sits *between two digits* (``1.5`` stays one token).
        """
        out = []
        n = len(line)
        for i, ch in enumerate(line):
            cat = unicodedata.category(ch)
            if cat.startswith("S"):
                out.append(f" {ch} ")
            elif cat.startswith("P"):
                prev_is_num = i > 0 and unicodedata.category(line[i - 1]).startswith("N")
                next_is_num = i + 1 < n and unicodedata.category(line[i + 1]).startswith("N")
                # split when adjacent to any non-number character
                if (i > 0 and not prev_is_num) or (i + 1 < n and not next_is_num):
                    out.append(f" {ch} ")
                else:
                    out.append(ch)
            else:
                out.append(ch)
        return "".join(out).strip().split()

    @classmethod
    def _tokenize_char(cls, line: str) -> Sequence[str]:
        # each character is a token; whitespace separates and is dropped
        return [ch for ch in line if not ch.isspace()]

    @staticmethod
    @lru_cache(maxsize=2**16)
    def _is_chinese_char(ch: str) -> bool:
        cp = ord(ch)
        return any(lo <= cp <= hi for lo, hi in _UCODE_RANGES)

    @classmethod
    def _tokenize_zh(cls, line: str) -> Sequence[str]:
        line = line.strip()
        out = []
        for ch in line:
            if cls._is_chinese_char(ch):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return cls._tokenize_13a("".join(out))


def sacre_bleu_score(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    smooth: bool = False,
    tokenize: str = "13a",
    lowercase: bool = False,
    weights: Optional[Sequence[float]] = None,
) -> torch.Tensor:
    """BLEU with a standard WMT tokenizer (a float32 CPU tensor).

    Example:
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> round(float(sacre_bleu_score(preds, target)), 4)
        0.7598
    """
    preds_, target_, weights = _bleu_normalize_inputs(preds, target, n_gram, weights)
    tokenizer = _SacreBLEUTokenizer(tokenize, lowercase)
    numerator, denominator, preds_len, target_len = _bleu_score_update(preds_, target_, n_gram, tokenizer)
    return _bleu_score_compute(
        _as_f32(preds_len), _as_f32(target_len), _as_f32(numerator), _as_f32(denominator), n_gram, weights, smooth
    )
