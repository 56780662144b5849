"""spectral_distortion_index / D_lambda (counterpart of ``metrics_tpu/functional/image/d_lambda.py``).

All C*(C+1)/2 channel pairs are scored with ONE depthwise convolution by
stacking every pair as an extra batch entry, as the JAX package does.
"""

from typing import Optional, Tuple

import torch

from metrics_tpu_torch.functional.image.uqi import _uqi_map
from metrics_tpu_torch.utils.checks import _as_tensor, _check_same_shape
from metrics_tpu_torch.utils.compute import _mean
from metrics_tpu_torch.utils.data import reduce


def _spectral_distortion_check_inputs(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shape and type validation."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if preds.dtype != target.dtype:
        raise TypeError(
            f"Expected `ms` and `fused` to have the same data type. Got ms: {preds.dtype}"
            f" and fused: {target.dtype}."
        )
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(
            f"Expected `preds` and `target` to have BxCxHxW shape. Got preds: {tuple(preds.shape)}"
            f" and target: {tuple(target.shape)}."
        )
    return preds, target


def _pairwise_uqi_means(x: torch.Tensor) -> torch.Tensor:
    """Mean UQI between every channel pair of ``x``; returns the symmetric ``(C, C)`` matrix.

    Every (k, r) pair becomes one single-channel batch row, so the whole
    matrix is one conv + one mean.
    """
    b, c, h, w = x.shape
    ks, rs = torch.triu_indices(c, c, device=x.device)
    # (P*B, 1, H, W) stacking: pair p occupies rows [p*b, (p+1)*b)
    lhs = x[:, ks].permute(1, 0, 2, 3).reshape(-1, 1, h, w)
    rhs = x[:, rs].permute(1, 0, 2, 3).reshape(-1, 1, h, w)
    uqi = _uqi_map(lhs, rhs)  # (P*B, 1, H', W')
    per_pair = _mean(uqi.reshape(len(ks), -1), dim=-1)
    m = torch.zeros((c, c), dtype=x.dtype, device=x.device)
    m[ks, rs] = per_pair
    m[rs, ks] = per_pair
    return m


def _spectral_distortion_index_compute(
    preds: torch.Tensor,
    target: torch.Tensor,
    p: int = 1,
    reduction: Optional[str] = "elementwise_mean",
) -> torch.Tensor:
    """D_lambda from the two cross-channel UQI matrices."""
    length = preds.shape[1]
    m1 = _pairwise_uqi_means(target)
    m2 = _pairwise_uqi_means(preds)
    diff = torch.abs(m1 - m2) ** p
    if length == 1:
        output = diff ** (1.0 / p)
    else:
        output = (torch.sum(diff) / (length * (length - 1))) ** (1.0 / p)
    return reduce(output, reduction)


def spectral_distortion_index(
    preds: torch.Tensor,
    target: torch.Tensor,
    p: int = 1,
    reduction: Optional[str] = "elementwise_mean",
) -> torch.Tensor:
    """Spectral Distortion Index, on the device of the inputs.

    Example:
        >>> import torch
        >>> preds = torch.rand((16, 3, 16, 16), generator=torch.Generator().manual_seed(0))
        >>> target = torch.rand((16, 3, 16, 16), generator=torch.Generator().manual_seed(1))
        >>> float(spectral_distortion_index(preds, target)) < 0.2
        True
    """
    if not isinstance(p, int) or p <= 0:
        raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
    preds, target = _spectral_distortion_check_inputs(preds, target)
    return _spectral_distortion_index_compute(preds, target, p, reduction)
