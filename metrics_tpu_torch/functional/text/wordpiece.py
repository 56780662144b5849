"""First-party WordPiece tokenizer (counterpart of ``metrics_tpu/functional/text/wordpiece.py``).

The port's own copy of the JAX package's pure-Python tokenizer, so that this
package imports nothing of it: BERT basic tokenization (Unicode clean-up,
lowercasing and accent stripping, punctuation and CJK splitting), then
greedy longest-match-first WordPiece with ``##`` continuation pieces.  It
answers the Hugging Face call convention that :func:`bert_score` uses:
``tok(texts, padding=..., max_length=..., truncation=True)`` returns
``input_ids`` and ``attention_mask`` lists framed by ``[CLS]`` and ``[SEP]``.
"""

import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Union

_PAD, _UNK, _CLS, _SEP, _MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges HF treats as punctuation even when unicode category differs
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


class WordPieceTokenizer:
    """BERT-style tokenizer over a plain vocab (one token per line or dict).

    Args:
        vocab: path to a vocab file, an iterable of tokens, or a
            token -> id mapping.
        do_lower_case: lowercase + strip accents (BERT-uncased behavior).
        max_input_chars_per_word: words longer than this become ``[UNK]``.

    Example:
        >>> from metrics_tpu_torch.functional.text.wordpiece import WordPieceTokenizer
        >>> tok = WordPieceTokenizer(
        ...     ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "un", "##aff", "##able", "runs", "!"]
        ... )
        >>> tok.tokenize("Unaffable runs!")
        ['un', '##aff', '##able', 'runs', '!']
        >>> enc = tok(["runs"], padding="max_length", max_length=5)
        >>> enc["input_ids"][0], enc["attention_mask"][0]
        ([2, 7, 3, 0, 0], [1, 1, 1, 0, 0])
    """

    def __init__(
        self,
        vocab: Union[str, Iterable[str], Dict[str, int]],
        do_lower_case: bool = True,
        max_input_chars_per_word: int = 100,
    ) -> None:
        if isinstance(vocab, str):
            with open(vocab, encoding="utf-8") as f:
                tokens = [line.rstrip("\n") for line in f if line.rstrip("\n")]
            self.vocab = {tok: i for i, tok in enumerate(tokens)}
        elif isinstance(vocab, dict):
            self.vocab = dict(vocab)
        else:
            self.vocab = {tok: i for i, tok in enumerate(vocab)}
        for special in (_PAD, _UNK, _CLS, _SEP):
            if special not in self.vocab:
                raise ValueError(f"vocab must contain the special token {special!r}")
        self.do_lower_case = do_lower_case
        self.max_input_chars_per_word = max_input_chars_per_word
        self.pad_token_id = self.vocab[_PAD]
        self.unk_token_id = self.vocab[_UNK]
        self.cls_token_id = self.vocab[_CLS]
        self.sep_token_id = self.vocab[_SEP]
        # word-level memoization (HF fast tokenizers cache the same way):
        # natural text is zipfian, so the normalize + greedy-match work per
        # DISTINCT word amortizes to a dict hit per occurrence
        self._word_ids_cache: Dict[str, List[int]] = {}
        self._cache_cap = 1 << 18  # bound memory on adversarial streams

    # ------------------------------------------------------ basic tokenizer
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if ch.isspace() else ch)
        return "".join(out)

    def _split_words(self, text: str) -> List[str]:
        """Whitespace/CJK pre-split (the per-word normalization is cached)."""
        if text.isascii():
            # printable ascii needs no cleanup (split() absorbs whitespace
            # runs) and cannot contain CJK — skip the per-char scans
            if not text.isprintable():
                text = self._clean(text)
            return text.split()
        text = self._clean(text)
        # CJK characters become standalone tokens (BERT convention)
        if any(_is_cjk(ord(ch)) for ch in text):
            spaced = []
            for ch in text:
                spaced.append(f" {ch} " if _is_cjk(ord(ch)) else ch)
            text = "".join(spaced)
        return text.split()

    def _normalize_word(self, word: str) -> List[str]:
        if self.do_lower_case:
            word = word.lower()
            word = unicodedata.normalize("NFD", word)
            word = "".join(ch for ch in word if unicodedata.category(ch) != "Mn")
        # split punctuation into standalone tokens
        out: List[str] = []
        cur: List[str] = []
        for ch in word:
            if _is_punctuation(ch):
                if cur:
                    out.append("".join(cur))
                    cur = []
                out.append(ch)
            else:
                cur.append(ch)
        if cur:
            out.append("".join(cur))
        return out

    def basic_tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self._split_words(text):
            out.extend(self._normalize_word(word))
        return out

    # -------------------------------------------------------- wordpiece
    def wordpiece(self, word: str) -> List[str]:
        """Greedy longest-match-first split into vocab pieces."""
        if len(word) > self.max_input_chars_per_word:
            return [_UNK]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur: Optional[str] = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = piece
                    break
                end -= 1
            if cur is None:
                return [_UNK]  # any unsplittable word is a single [UNK]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self.basic_tokenize(text):
            out.extend(self.wordpiece(word))
        return out

    def _word_to_ids(self, raw_word: str) -> List[int]:
        """normalize + wordpiece + ids for one raw word, memoized."""
        cached = self._word_ids_cache.get(raw_word)
        if cached is None:
            ids: List[int] = []
            for sub in self._normalize_word(raw_word):
                for piece in self.wordpiece(sub):
                    ids.append(self.vocab.get(piece, self.unk_token_id))
            if len(self._word_ids_cache) >= self._cache_cap:
                self._word_ids_cache.clear()
            self._word_ids_cache[raw_word] = cached = ids
        return cached

    def text_to_ids(self, text: str) -> List[int]:
        """Token ids for a text (no specials), via the per-word cache."""
        ids: List[int] = []
        for word in self._split_words(text):
            ids.extend(self._word_to_ids(word))
        return ids

    # ----------------------------------------------------- HF call surface
    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]

    def __call__(
        self,
        texts: Sequence[str],
        padding: Union[bool, str, None] = "max_length",
        max_length: int = 512,
        truncation: bool = True,
        return_attention_mask: bool = True,
    ) -> Dict[str, List[List[int]]]:
        ids_batch, mask_batch = [], []
        for text in texts:
            ids = self.text_to_ids(text)
            if truncation:
                ids = ids[: max_length - 2]
            ids = [self.cls_token_id] + ids + [self.sep_token_id]
            mask = [1] * len(ids)
            if padding:
                pad = max_length - len(ids)
                ids = ids + [self.pad_token_id] * pad
                mask = mask + [0] * pad
            ids_batch.append(ids)
            mask_batch.append(mask)
        out = {"input_ids": ids_batch}
        if return_attention_mask:
            out["attention_mask"] = mask_batch
        return out


def build_wordpiece_vocab(corpus: Sequence[str], size: int = 8000, do_lower_case: bool = True) -> List[str]:
    """Frequency-based WordPiece vocab from a corpus (offline helper).

    Not the original likelihood-driven trainer — whole words and frequent
    substrings by count — but it produces a realistic piece distribution for
    benchmarking and for fully-offline tokenizer use.
    """
    from collections import Counter

    helper = WordPieceTokenizer.__new__(WordPieceTokenizer)
    helper.do_lower_case = do_lower_case
    words = Counter()
    for text in corpus:
        words.update(helper.basic_tokenize(text))
    vocab: List[str] = [_PAD, _UNK, _CLS, _SEP, _MASK]
    seen = set(vocab)
    # every character (initial and continuation form) so no word is ever UNK
    chars = Counter()
    for w, c in words.items():
        for i, ch in enumerate(w):
            chars[ch if i == 0 else "##" + ch] += c
    pieces = Counter()
    for w, c in words.items():
        for ln in (2, 3, 4, 6):
            for s in range(0, max(1, len(w) - ln + 1)):
                sub = w[s : s + ln]
                if len(sub) < ln:
                    continue
                pieces[sub if s == 0 else "##" + sub] += c
    ranked = [t for t, _ in chars.most_common()] + [w for w, _ in words.most_common()] + [
        t for t, _ in pieces.most_common()
    ]
    for tok in ranked:
        if tok not in seen:
            vocab.append(tok)
            seen.add(tok)
        if len(vocab) >= size:
            break
    return vocab
