"""spectral_angle_mapper (counterpart of ``metrics_tpu/functional/image/sam.py``)."""

from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utils.checks import _as_tensor, _check_same_shape
from metrics_tpu_torch.utils.data import reduce


def _sam_check_inputs(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
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
    if preds.shape[1] <= 1:
        raise ValueError(
            "Expected channel dimension of `preds` and `target` to be larger than 1."
            f" Got preds: {preds.shape[1]} and target: {target.shape[1]}."
        )
    return preds, target


def _sam_map(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-pixel spectral angle, shape ``(B, H, W)``."""
    dot_product = (preds * target).sum(dim=1)
    preds_norm = torch.linalg.vector_norm(preds, dim=1)
    target_norm = torch.linalg.vector_norm(target, dim=1)
    return torch.arccos(torch.clamp(dot_product / (preds_norm * target_norm), -1, 1))


def spectral_angle_mapper(
    preds: torch.Tensor,
    target: torch.Tensor,
    reduction: Optional[str] = "elementwise_mean",
) -> torch.Tensor:
    """Spectral angle between pixel spectra, on the device of the inputs.

    Example:
        >>> import torch
        >>> preds = torch.rand((16, 3, 16, 16), generator=torch.Generator().manual_seed(42))
        >>> target = torch.rand((16, 3, 16, 16), generator=torch.Generator().manual_seed(123))
        >>> 0 < float(spectral_angle_mapper(preds, target)) < 1.6
        True
    """
    preds, target = _sam_check_inputs(preds, target)
    return reduce(_sam_map(preds, target), reduction)
