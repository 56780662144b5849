"""SNR and SI-SNR (counterpart of ``metrics_tpu/functional/audio/snr.py``)."""

import torch

from metrics_tpu_torch.utils.checks import _as_tensor, _check_same_shape


def _mean_last(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(x, axis=-1, keepdims=True)``: the sum over a device count (a
    division, not a multiplication by the reciprocal)."""
    n = torch.full((), x.shape[-1], dtype=x.dtype, device=x.device)
    return x.sum(-1, keepdim=True) / n


def signal_noise_ratio(preds: torch.Tensor, target: torch.Tensor, zero_mean: bool = False) -> torch.Tensor:
    """SNR in dB over the last (time) axis, on the device of the inputs.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(signal_noise_ratio(preds, target)), 4)
        16.1805
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    _check_same_shape(preds, target)
    eps = torch.finfo(preds.dtype).eps
    if zero_mean:
        target = target - _mean_last(target)
        preds = preds - _mean_last(preds)
    noise = target - preds
    snr_value = ((target * target).sum(-1) + eps) / ((noise * noise).sum(-1) + eps)
    return 10 * torch.log10(snr_value)


def scale_invariant_signal_noise_ratio(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """SI-SNR: SI-SDR of zero-mean signals.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(scale_invariant_signal_noise_ratio(preds, target)), 4)
        15.0918
    """
    from metrics_tpu_torch.functional.audio.sdr import scale_invariant_signal_distortion_ratio

    return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=True)
