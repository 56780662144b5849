"""Numeric helpers (counterpart of ``metrics_tpu/utils/compute.py``)."""

from typing import Optional

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


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """A correctly rounded square root, as ``jnp.sqrt`` and IEEE 754 give it.

    Some CPU builds of PyTorch compute a float32 ``torch.sqrt`` (and ``x ** 0.5``)
    a unit in the last place off the correctly rounded root.  On the CPU a
    float32, float16 or bfloat16 root is taken in float64 and rounded once:
    float64 carries more than twice the bits plus two, so that rounding is
    exact.  On the card ``torch.sqrt`` is ``sqrt.rn`` already.
    """
    if x.device.type == "cpu" and x.dtype in (torch.float32, torch.float16, torch.bfloat16):
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def _norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """The Euclidean norm along ``dim``: a sum of squares, then :func:`_sqrt`."""
    return _sqrt((x * x).sum(dim, keepdim=keepdim))


def _count(n: int, device: torch.device) -> torch.Tensor:
    """An int32 count on ``device``, as ``jnp.asarray(n)`` holds it (one fill, no host copy)."""
    return torch.full((), n, dtype=torch.int32, device=device)


def _mean(x: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """``jnp.mean``: the sum divided by the count as a device tensor.

    A CUDA ``torch.mean`` (or a division by a host number) multiplies by the
    reciprocal, an ulp off the quotient that the CPU and the JAX package give.
    """
    total = x.sum() if dim is None else x.sum(dim)
    n = x.numel() if dim is None else x.shape[dim]
    return total / torch.full((), n, dtype=total.dtype, device=x.device)
