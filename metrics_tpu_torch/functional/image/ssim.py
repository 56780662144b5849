"""structural_similarity_index_measure and its multiscale variant
(counterpart of ``metrics_tpu/functional/image/ssim.py``).

The five sliding-window moments (mu_p, mu_t, E[p^2], E[t^2], E[pt]) come
from ONE depthwise convolution over a stacked ``(5B, C, ...)`` batch, in full
float32 (:func:`~metrics_tpu_torch.functional.image.helper._depthwise_conv`).
"""

from typing import Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.image.helper import (
    _avg_pool,
    _depthwise_conv,
    _gaussian_kernel_2d,
    _gaussian_kernel_3d,
    _reflection_pad,
)
from metrics_tpu_torch.utils.checks import _as_tensor, _check_same_shape
from metrics_tpu_torch.utils.compute import _mean
from metrics_tpu_torch.utils.data import reduce


def _ssim_check_inputs(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shape and type validation."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {preds.dtype} and target: {target.dtype}."
        )
    _check_same_shape(preds, target)
    if preds.ndim not in (4, 5):
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW or BxCxDxHxW shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    return preds, target


def _validate_kernel_sigma(kernel_size: Sequence[int], sigma: Sequence[float], ndim: int) -> None:
    for name, val in (("kernel_size", kernel_size), ("sigma", sigma)):
        if len(val) != ndim - 2:
            raise ValueError(
                f"`{name}` has dimension {len(val)}, but expected to be two less that target"
                f" dimensionality, which is: {ndim}"
            )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")


def _ssim_per_image(
    preds: torch.Tensor,
    target: torch.Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
):
    """Per-image SSIM scores, shape ``(B,)`` (with the contrast sensitivity or the full map when asked)."""
    is_3d = preds.ndim == 5
    nd = preds.ndim - 2
    if not isinstance(kernel_size, Sequence):
        kernel_size = nd * [kernel_size]
    if not isinstance(sigma, Sequence):
        sigma = nd * [sigma]
    _validate_kernel_sigma(kernel_size, sigma, preds.ndim)

    if data_range is None:
        data_range = torch.maximum(preds.max() - preds.min(), target.max() - target.min())
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    channel = preds.shape[1]
    # the gaussian window size is derived from sigma
    gauss_kernel_size = [int(3.5 * s + 0.5) * 2 + 1 for s in sigma]
    pads = [(k - 1) // 2 for k in gauss_kernel_size]

    preds = _reflection_pad(preds, pads)
    target = _reflection_pad(target, pads)
    if gaussian_kernel:
        make = _gaussian_kernel_3d if is_3d else _gaussian_kernel_2d
        kernel = make(channel, gauss_kernel_size, sigma, preds.dtype, preds.device)
    else:
        size = 1
        for k in kernel_size:
            size *= k
        kernel = (torch.ones(tuple(kernel_size), dtype=preds.dtype, device=preds.device) / size).expand(
            channel, 1, *kernel_size
        )

    batch = preds.shape[0]
    stacked = torch.cat((preds, target, preds * preds, target * target, preds * target))  # (5B, C, ...)
    out = _depthwise_conv(stacked, kernel)
    mu_pred, mu_target, e_pred_sq, e_target_sq, e_pred_target = (out[i * batch : (i + 1) * batch] for i in range(5))

    mu_pred_sq = torch.square(mu_pred)
    mu_target_sq = torch.square(mu_target)
    mu_pred_target = mu_pred * mu_target

    sigma_pred_sq = e_pred_sq - mu_pred_sq
    sigma_target_sq = e_target_sq - mu_target_sq
    sigma_pred_target = e_pred_target - mu_pred_target

    upper = 2 * sigma_pred_target + c2
    lower = sigma_pred_sq + sigma_target_sq + c2
    ssim_full = ((2 * mu_pred_target + c1) * upper) / ((mu_pred_sq + mu_target_sq + c1) * lower)

    # crop each dim's pad-influenced border
    crop = (Ellipsis,) + tuple(slice(p, -p if p > 0 else None) for p in pads)
    per_image = _mean(ssim_full[crop].reshape(batch, -1), dim=-1)

    if return_contrast_sensitivity:
        cs = (upper / lower)[crop]
        return per_image, _mean(cs.reshape(batch, -1), dim=-1)
    if return_full_image:
        return per_image, ssim_full
    return per_image


def _ssim_compute(
    preds: torch.Tensor,
    target: torch.Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
):
    out = _ssim_per_image(
        preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2,
        return_full_image, return_contrast_sensitivity,
    )
    if return_contrast_sensitivity or return_full_image:
        per_image, second = out
        return reduce(per_image, reduction), reduce(second, reduction)
    return reduce(out, reduction)


def structural_similarity_index_measure(
    preds: torch.Tensor,
    target: torch.Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
):
    """SSIM between image batches, on the device of the inputs.

    Example:
        >>> import torch
        >>> preds = torch.rand((16, 1, 16, 16), generator=torch.Generator().manual_seed(0))
        >>> target = preds * 0.75
        >>> float(structural_similarity_index_measure(preds, target)) > 0.9
        True
    """
    preds, target = _ssim_check_inputs(preds, target)
    return _ssim_compute(
        preds, target, gaussian_kernel, sigma, kernel_size, reduction, data_range,
        k1, k2, return_full_image, return_contrast_sensitivity,
    )


def _multiscale_ssim_stacks(
    preds: torch.Tensor,
    target: torch.Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw per-scale, per-image (sim, cs) stacks of shape ``(S, B)``."""
    nd = preds.ndim - 2
    if not isinstance(kernel_size, Sequence):
        kernel_size = nd * [kernel_size]
    if not isinstance(sigma, Sequence):
        sigma = nd * [sigma]

    if preds.shape[-1] < 2 ** len(betas) or preds.shape[-2] < 2 ** len(betas):
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)}, the image height and width"
            f" dimensions must be larger than or equal to {2 ** len(betas)}."
        )
    _betas_div = max(1, (len(betas) - 1)) ** 2
    if preds.shape[-2] // _betas_div <= kernel_size[0] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size"
            f" {kernel_size[0]}, the image height must be larger than"
            f" {(kernel_size[0] - 1) * _betas_div}."
        )
    if preds.shape[-1] // _betas_div <= kernel_size[1] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size"
            f" {kernel_size[1]}, the image width must be larger than"
            f" {(kernel_size[1] - 1) * _betas_div}."
        )

    sims, css = [], []
    for _ in range(len(betas)):
        sim, cs = _ssim_per_image(
            preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2,
            return_contrast_sensitivity=True,
        )
        sims.append(sim)
        css.append(cs)
        preds = _avg_pool(preds)
        target = _avg_pool(target)
    return torch.stack(sims), torch.stack(css)  # (S, B) each


def _msssim_combine(
    sim_stack: torch.Tensor,
    cs_stack: torch.Tensor,
    betas: Tuple[float, ...],
    reduction: Optional[str],
    normalize: Optional[str],
) -> torch.Tensor:
    """Normalize, reduce over the batch axis, and combine scales.

    sim and cs are reduced over the batch at EVERY scale before the
    beta-weighted product, so for mean/sum the result is a function of the
    per-scale batch statistics, not a mean of per-image products.
    """
    if reduction in ("none", None):
        pass  # keep (S, B)
    elif reduction == "sum":
        sim_stack, cs_stack = sim_stack.sum(dim=1), cs_stack.sum(dim=1)
    else:
        sim_stack, cs_stack = _mean(sim_stack, dim=1), _mean(cs_stack, dim=1)
    if normalize == "relu":
        sim_stack, cs_stack = torch.relu(sim_stack), torch.relu(cs_stack)
    elif normalize == "simple":
        sim_stack = (sim_stack + 1) / 2
        cs_stack = (cs_stack + 1) / 2
    betas_arr = torch.tensor(betas, dtype=torch.float32, device=sim_stack.device)
    betas_arr = betas_arr.reshape((-1,) + (1,) * (sim_stack.ndim - 1))
    sim_stack = sim_stack**betas_arr
    cs_stack = cs_stack**betas_arr
    return torch.prod(cs_stack[:-1], dim=0) * sim_stack[-1]


def multiscale_structural_similarity_index_measure(
    preds: torch.Tensor,
    target: torch.Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = None,
) -> torch.Tensor:
    """Multi-scale SSIM, on the device of the inputs.

    Example:
        >>> import torch
        >>> preds = torch.rand((1, 1, 256, 256), generator=torch.Generator().manual_seed(42))
        >>> target = preds * 0.75
        >>> float(multiscale_structural_similarity_index_measure(preds, target)) > 0.9
        True
    """
    if not isinstance(betas, tuple):
        raise ValueError("Argument `betas` is expected to be of a type tuple.")
    if not all(isinstance(beta, float) for beta in betas):
        raise ValueError("Argument `betas` is expected to be a tuple of floats.")
    if normalize and normalize not in ("relu", "simple"):
        raise ValueError("Argument `normalize` to be expected either `None` or one of 'relu' or 'simple'")
    preds, target = _ssim_check_inputs(preds, target)
    sim_stack, cs_stack = _multiscale_ssim_stacks(
        preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2, betas
    )
    return _msssim_combine(sim_stack, cs_stack, betas, reduction, normalize)
