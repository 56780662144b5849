"""Numeric helpers (counterpart of ``metrics_tpu/utils/compute.py``)."""

import torch


def _safe_divide(num: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """num / denom with 0/0 := 0 (and x/0 := 0); integer inputs give float32."""
    if not num.is_floating_point():
        num = num.to(torch.float32)
    zero = denom == 0
    quotient = num / torch.where(zero, torch.ones_like(denom), denom)
    return torch.where(zero, torch.zeros_like(quotient), quotient)


def _safe_xlogy(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x * log(y), with 0 * log(y) := 0 wherever x == 0, even where y is 0 or NaN."""
    res = torch.xlogy(x, y)
    return torch.where(x == 0.0, torch.zeros_like(res), res)
