"""universal_image_quality_index (counterpart of ``metrics_tpu/functional/image/uqi.py``)."""

from typing import Optional, Sequence, Tuple

import torch

from metrics_tpu_torch.functional.image.helper import _depthwise_conv, _gaussian_kernel_2d, _reflection_pad
from metrics_tpu_torch.utils.checks import _as_tensor, _check_same_shape
from metrics_tpu_torch.utils.data import reduce


def _uqi_check_inputs(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shape and type validation."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {preds.dtype} and target: {target.dtype}."
        )
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    return preds, target


def _uqi_map(
    preds: torch.Tensor,
    target: torch.Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
) -> torch.Tensor:
    """Per-pixel UQI map of shape ``(B, C, H', W')``: one depthwise convolution of the five stacked moments."""
    if len(kernel_size) != 2 or len(sigma) != 2:
        raise ValueError(
            "Expected `kernel_size` and `sigma` to have the length of two."
            f" Got kernel_size: {len(kernel_size)} and sigma: {len(sigma)}."
        )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")

    channel = preds.shape[1]
    kernel = _gaussian_kernel_2d(channel, kernel_size, sigma, preds.dtype, preds.device)
    pad_h = (kernel_size[0] - 1) // 2
    pad_w = (kernel_size[1] - 1) // 2
    preds = _reflection_pad(preds, (pad_h, pad_w))
    target = _reflection_pad(target, (pad_h, pad_w))

    batch = preds.shape[0]
    stacked = torch.cat((preds, target, preds * preds, target * target, preds * target))
    out = _depthwise_conv(stacked, kernel)
    mu_pred, mu_target, e_pred_sq, e_target_sq, e_pred_target = (out[i * batch : (i + 1) * batch] for i in range(5))

    mu_pred_sq = torch.square(mu_pred)
    mu_target_sq = torch.square(mu_target)
    mu_pred_target = mu_pred * mu_target
    sigma_pred_sq = e_pred_sq - mu_pred_sq
    sigma_target_sq = e_target_sq - mu_target_sq
    sigma_pred_target = e_pred_target - mu_pred_target

    upper = 2 * sigma_pred_target
    lower = sigma_pred_sq + sigma_target_sq
    uqi_idx = ((2 * mu_pred_target) * upper) / ((mu_pred_sq + mu_target_sq) * lower)
    # crop each dim's pad-influenced border independently
    return uqi_idx[..., slice(pad_h, -pad_h if pad_h > 0 else None), slice(pad_w, -pad_w if pad_w > 0 else None)]


def universal_image_quality_index(
    preds: torch.Tensor,
    target: torch.Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[float] = None,
) -> torch.Tensor:
    """UQI between image batches, on the device of the inputs.  ``data_range`` is accepted
    for API parity; the UQI formula has no stabilization constants, so it is unused.

    Example:
        >>> import torch
        >>> preds = torch.rand((16, 1, 16, 16), generator=torch.Generator().manual_seed(0))
        >>> target = preds * 0.75
        >>> float(universal_image_quality_index(preds, target)) > 0.9
        True
    """
    preds, target = _uqi_check_inputs(preds, target)
    return reduce(_uqi_map(preds, target, kernel_size, sigma), reduction)
