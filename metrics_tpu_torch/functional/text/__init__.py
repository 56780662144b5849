"""Text functionals (counterpart of ``metrics_tpu/functional/text/``): the WER family so far."""

from metrics_tpu_torch.functional.text.cer import char_error_rate
from metrics_tpu_torch.functional.text.mer import match_error_rate
from metrics_tpu_torch.functional.text.wer import word_error_rate
from metrics_tpu_torch.functional.text.wil import word_information_lost
from metrics_tpu_torch.functional.text.wip import word_information_preserved

__all__ = [
    "char_error_rate",
    "match_error_rate",
    "word_error_rate",
    "word_information_lost",
    "word_information_preserved",
]
