"""Shared image-metric kernels (counterpart of ``metrics_tpu/functional/image/helper.py``).

The sliding-window moments are depthwise VALID convolutions
(``F.conv2d``/``F.conv3d`` with ``groups=C``) under a full-float32 cuDNN
(:func:`_depthwise_conv`): PyTorch lets cuDNN convolve float32 in TF32 by
default, which keeps 10 bits of mantissa.  The gaussian window is built as an
outer product of 1D gaussians.
"""

from typing import Sequence

import torch
import torch.nn.functional as F


def _gaussian(kernel_size: int, sigma: float, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """1D gaussian window, normalized to sum 1, shape ``(1, kernel_size)``."""
    dist = torch.arange((1 - kernel_size) / 2, (1 + kernel_size) / 2, 1.0, dtype=dtype, device=device)
    gauss = torch.exp(-torch.square(dist / sigma) / 2)
    return (gauss / gauss.sum())[None, :]


def _gaussian_kernel_2d(
    channel: int, kernel_size: Sequence[int], sigma: Sequence[float], dtype: torch.dtype = torch.float32, device=None
) -> torch.Tensor:
    """Per-channel 2D gaussian of shape ``(C, 1, kh, kw)``."""
    kx = _gaussian(kernel_size[0], sigma[0], dtype, device)
    ky = _gaussian(kernel_size[1], sigma[1], dtype, device)
    kernel = kx.T @ ky  # (kh, kw)
    return kernel.expand(channel, 1, kernel_size[0], kernel_size[1])


def _gaussian_kernel_3d(
    channel: int, kernel_size: Sequence[int], sigma: Sequence[float], dtype: torch.dtype = torch.float32, device=None
) -> torch.Tensor:
    """Per-channel 3D gaussian of shape ``(C, 1, kd, kh, kw)``."""
    kx = _gaussian(kernel_size[0], sigma[0], dtype, device)
    ky = _gaussian(kernel_size[1], sigma[1], dtype, device)
    kz = _gaussian(kernel_size[2], sigma[2], dtype, device)
    kernel_xy = kx.T @ ky  # (kx, ky)
    kernel = kernel_xy[:, :, None] * kz[0][None, None, :]
    return kernel.expand(channel, 1, *kernel_size)


def _depthwise_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise VALID conv in full float32; ``x``: (B, C, *spatial), ``kernel``: (C, 1, *window).

    cuDNN's TF32 is switched off for this call alone (``torch.backends.cudnn.flags``),
    whatever the process-wide setting; its other flags keep their values.
    """
    conv = F.conv2d if x.ndim == 4 else F.conv3d
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                     allow_tf32=False):
        return conv(x, kernel.to(x.dtype).contiguous(), groups=x.shape[1])


def _reflection_pad(x: torch.Tensor, pads: Sequence[int]) -> torch.Tensor:
    """Reflect-pad the trailing spatial dims; ``pads`` gives the symmetric pad per spatial dim."""
    widths = []
    for p in reversed(pads):  # F.pad lists the last dim first
        widths += [p, p]
    return F.pad(x, widths, mode="reflect")


def _avg_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Non-overlapping average pool over the trailing spatial dims (MS-SSIM's downsampling)."""
    return (F.avg_pool2d if x.ndim == 4 else F.avg_pool3d)(x, window)
