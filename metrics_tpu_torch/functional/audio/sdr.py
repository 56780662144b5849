"""SDR and SI-SDR (counterpart of ``metrics_tpu/functional/audio/sdr.py``).

SDR fits the optimal distortion filter of ``filter_length`` taps through the
Toeplitz normal equations: the auto- and cross-correlations come from real
FFTs at the next power of two, the Toeplitz matrix is an index gather, and
the solve is one batched float32 ``torch.linalg.solve`` on the inputs'
device (the JAX package solves in float32 with x64 off).  The signals are
scaled to unit norm first, which keeps the system well conditioned.
"""

from typing import Optional, Tuple

import torch

from metrics_tpu_torch.functional.audio.snr import _mean_last
from metrics_tpu_torch.utils.checks import _as_tensor, _check_same_shape
from metrics_tpu_torch.utils.compute import _norm


def _symmetric_toeplitz(vector: torch.Tensor) -> torch.Tensor:
    """The symmetric Toeplitz matrix of a first row, batched over leading dims.

    Example:
        >>> import torch
        >>> _symmetric_toeplitz(torch.tensor([0.0, 1.0, 2.0]))
        tensor([[0., 1., 2.],
                [1., 0., 1.],
                [2., 1., 0.]])
    """
    n = vector.shape[-1]
    ar = torch.arange(n, device=vector.device)
    idx = (ar[:, None] - ar[None, :]).abs()
    return vector[..., idx]


def _compute_autocorr_crosscorr(
    target: torch.Tensor, preds: torch.Tensor, corr_len: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The target's autocorrelation and its cross-correlation with the prediction, through rFFTs."""
    n = preds.shape[-1] + target.shape[-1] - 1
    n_fft = 1 << (n - 1).bit_length()
    t_fft = torch.fft.rfft(target, n=n_fft, dim=-1)
    r_0 = torch.fft.irfft(t_fft.real**2 + t_fft.imag**2, n=n_fft, dim=-1)[..., :corr_len]
    p_fft = torch.fft.rfft(preds, n=n_fft, dim=-1)
    b = torch.fft.irfft(torch.conj(t_fft) * p_fft, n=n_fft, dim=-1)[..., :corr_len]
    return r_0, b


def signal_distortion_ratio(
    preds: torch.Tensor,
    target: torch.Tensor,
    use_cg_iter: Optional[int] = None,
    filter_length: int = 512,
    zero_mean: bool = False,
    load_diag: Optional[float] = None,
) -> torch.Tensor:
    """SDR in dB with an optimal distortion filter (shape ``[...]``), on the inputs' device.

    ``use_cg_iter`` is accepted and ignored, as in the JAX package: the dense
    batched solve needs no conjugate-gradient iterations.  The filter takes at
    most as many taps as the signal has samples (more would make the normal
    equations singular).
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    _check_same_shape(preds, target)
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    if zero_mean:
        preds = preds - _mean_last(preds)
        target = target - _mean_last(target)
    target = target / torch.clamp_min(_norm(target, -1, keepdim=True), 1e-6)
    preds = preds / torch.clamp_min(_norm(preds, -1, keepdim=True), 1e-6)
    corr_len = min(filter_length, target.shape[-1])
    r_0, b = _compute_autocorr_crosscorr(target, preds, corr_len=corr_len)
    if load_diag is not None:
        r_0 = torch.cat([r_0[..., :1] + load_diag, r_0[..., 1:]], dim=-1)
    r = _symmetric_toeplitz(r_0)
    sol = torch.linalg.solve(r, b[..., None])[..., 0]
    coh = (b * sol).sum(-1)
    ratio = coh / (1 - coh)
    return 10.0 * torch.log10(ratio)


def scale_invariant_signal_distortion_ratio(
    preds: torch.Tensor, target: torch.Tensor, zero_mean: bool = False
) -> torch.Tensor:
    """SI-SDR in dB over the last axis, on the inputs' device.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(scale_invariant_signal_distortion_ratio(preds, target)), 4)
        18.403
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    _check_same_shape(preds, target)
    eps = torch.finfo(preds.dtype).eps
    if zero_mean:
        target = target - _mean_last(target)
        preds = preds - _mean_last(preds)
    alpha = ((preds * target).sum(-1, keepdim=True) + eps) / ((target * target).sum(-1, keepdim=True) + eps)
    target_scaled = alpha * target
    noise = target_scaled - preds
    val = ((target_scaled * target_scaled).sum(-1) + eps) / ((noise * noise).sum(-1) + eps)
    return 10 * torch.log10(val)
