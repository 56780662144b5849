"""SignalNoiseRatio and ScaleInvariantSignalNoiseRatio (counterpart of ``metrics_tpu/audio/snr.py``)."""

from typing import Any

import torch

from metrics_tpu_torch.audio._base import _SignalMean
from metrics_tpu_torch.functional.audio.snr import scale_invariant_signal_noise_ratio, signal_noise_ratio


class SignalNoiseRatio(_SignalMean):
    """Mean SNR in dB over the stream (``sum_snr`` float32, ``total`` int32).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SignalNoiseRatio
        >>> metric = SignalNoiseRatio(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(metric.compute()), 4)
        16.1805
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    _sum_state = "sum_snr"

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean

    def _scores(self, preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return signal_noise_ratio(preds=preds, target=target, zero_mean=self.zero_mean)


class ScaleInvariantSignalNoiseRatio(_SignalMean):
    """Mean SI-SNR in dB over the stream (``sum_si_snr`` float32, ``total`` int32)."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    _sum_state = "sum_si_snr"

    def _scores(self, preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return scale_invariant_signal_noise_ratio(preds=preds, target=target)
