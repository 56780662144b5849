"""Text functionals (counterpart of ``metrics_tpu/functional/text/``)."""

from metrics_tpu_torch.functional.text.bert import bert_score
from metrics_tpu_torch.functional.text.bleu import bleu_score
from metrics_tpu_torch.functional.text.cer import char_error_rate
from metrics_tpu_torch.functional.text.chrf import chrf_score
from metrics_tpu_torch.functional.text.eed import extended_edit_distance
from metrics_tpu_torch.functional.text.mer import match_error_rate
from metrics_tpu_torch.functional.text.rouge import rouge_score
from metrics_tpu_torch.functional.text.sacre_bleu import sacre_bleu_score
from metrics_tpu_torch.functional.text.squad import squad
from metrics_tpu_torch.functional.text.ter import translation_edit_rate
from metrics_tpu_torch.functional.text.wer import word_error_rate
from metrics_tpu_torch.functional.text.wil import word_information_lost
from metrics_tpu_torch.functional.text.wip import word_information_preserved
from metrics_tpu_torch.functional.text.wordpiece import WordPieceTokenizer, build_wordpiece_vocab

__all__ = [
    "WordPieceTokenizer",
    "bert_score",
    "bleu_score",
    "build_wordpiece_vocab",
    "char_error_rate",
    "chrf_score",
    "extended_edit_distance",
    "match_error_rate",
    "rouge_score",
    "sacre_bleu_score",
    "squad",
    "translation_edit_rate",
    "word_error_rate",
    "word_information_lost",
    "word_information_preserved",
]
