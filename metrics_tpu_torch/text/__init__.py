"""Text module metrics (counterpart of ``metrics_tpu/text/``): the WER family so far."""

from metrics_tpu_torch.text.cer import CharErrorRate
from metrics_tpu_torch.text.mer import MatchErrorRate
from metrics_tpu_torch.text.wer import WordErrorRate
from metrics_tpu_torch.text.wil import WordInfoLost
from metrics_tpu_torch.text.wip import WordInfoPreserved

__all__ = [
    "CharErrorRate",
    "MatchErrorRate",
    "WordErrorRate",
    "WordInfoLost",
    "WordInfoPreserved",
]
