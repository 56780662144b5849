"""SignalDistortionRatio and ScaleInvariantSignalDistortionRatio (counterpart of ``metrics_tpu/audio/sdr.py``)."""

from typing import Any, Optional

import torch

from metrics_tpu_torch.audio._base import _SignalMean
from metrics_tpu_torch.functional.audio.sdr import scale_invariant_signal_distortion_ratio, signal_distortion_ratio


class SignalDistortionRatio(_SignalMean):
    """Mean SDR in dB over the stream (``sum_sdr`` float32, ``total`` int32);
    each batch is one batched solve on the inputs' device."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    _sum_state = "sum_sdr"

    def __init__(
        self,
        use_cg_iter: Optional[int] = None,
        filter_length: int = 512,
        zero_mean: bool = False,
        load_diag: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.use_cg_iter = use_cg_iter
        self.filter_length = filter_length
        self.zero_mean = zero_mean
        self.load_diag = load_diag

    def _scores(self, preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return signal_distortion_ratio(
            preds, target, self.use_cg_iter, self.filter_length, self.zero_mean, self.load_diag
        )


class ScaleInvariantSignalDistortionRatio(_SignalMean):
    """Mean SI-SDR in dB over the stream (``sum_si_sdr`` float32, ``total`` int32)."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    _sum_state = "sum_si_sdr"

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean

    def _scores(self, preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=self.zero_mean)
