"""PerceptualEvaluationSpeechQuality (counterpart of ``metrics_tpu/audio/pesq.py``)."""

from typing import Any

import torch

from metrics_tpu_torch.audio._base import _SignalMean
from metrics_tpu_torch.functional.audio.pesq import _PESQ_MISSING, perceptual_evaluation_speech_quality
from metrics_tpu_torch.utils.imports import _PESQ_AVAILABLE


class PerceptualEvaluationSpeechQuality(_SignalMean):
    """Mean PESQ over the stream (``sum_pesq`` float32, ``total`` int32) through
    the optional ``pesq`` package; construction raises where it is missing."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    _sum_state = "sum_pesq"

    def __init__(self, fs: int, mode: str, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not _PESQ_AVAILABLE:
            raise ModuleNotFoundError(_PESQ_MISSING)
        if fs not in (8000, 16000):
            raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
        if mode not in ("wb", "nb"):
            raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
        self.fs = fs
        self.mode = mode

    def _scores(self, preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return perceptual_evaluation_speech_quality(preds, target, self.fs, self.mode)
