"""ShortTimeObjectiveIntelligibility (counterpart of ``metrics_tpu/audio/stoi.py``)."""

from typing import Any

import torch

from metrics_tpu_torch.audio._base import _SignalMean
from metrics_tpu_torch.functional.audio.stoi import _PYSTOI_MISSING, short_time_objective_intelligibility
from metrics_tpu_torch.utils.imports import _PYSTOI_AVAILABLE


class ShortTimeObjectiveIntelligibility(_SignalMean):
    """Mean STOI over the stream (``sum_stoi`` float32, ``total`` int32) through
    the optional ``pystoi`` package; construction raises where it is missing."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    _sum_state = "sum_stoi"

    def __init__(self, fs: int, extended: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not _PYSTOI_AVAILABLE:
            raise ModuleNotFoundError(_PYSTOI_MISSING)
        self.fs = fs
        self.extended = extended

    def _scores(self, preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return short_time_objective_intelligibility(preds, target, self.fs, self.extended)
