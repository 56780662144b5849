"""Data / reduction helpers (counterpart of ``metrics_tpu/utils/data.py``)."""

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch


def dim_zero_cat(x: Union[torch.Tensor, List[torch.Tensor], tuple]) -> torch.Tensor:
    """Concatenate a list state along dim 0 (identity on a lone tensor)."""
    if not isinstance(x, (list, tuple)):
        return x
    if len(x) == 0:
        raise ValueError("No samples to concatenate")
    return torch.cat([torch.atleast_1d(v) for v in x], dim=0)


_X32 = {torch.int64: torch.int32, torch.float64: torch.float32, torch.complex128: torch.complex64}


def _x32_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype ``jnp.asarray`` gives an array of ``dtype`` with ``jax_enable_x64`` off."""
    return _X32.get(dtype, dtype)


def _x32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the dtype the JAX package would hold it in: int64 as int32, float64 as float32."""
    return x.to(_x32_dtype(x.dtype))


def dim_zero_sum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x, dim=0)


def dim_zero_mean(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x, dim=0)


def dim_zero_max(x: torch.Tensor) -> torch.Tensor:
    return torch.max(x, dim=0).values


def dim_zero_min(x: torch.Tensor) -> torch.Tensor:
    return torch.min(x, dim=0).values


def _flatten_dict(x: Dict) -> Dict:
    """Flatten dict-of-dicts one level."""
    new_dict = {}
    for key, value in x.items():
        if isinstance(value, dict):
            new_dict.update(value)
        else:
            new_dict[key] = value
    return new_dict


def to_onehot(label_tensor: torch.Tensor, num_classes: Optional[int] = None) -> torch.Tensor:
    """Dense labels ``(N, ...)`` to an int32 one-hot ``(N, C, ...)``.

    A comparison against ``arange(C)`` rather than ``F.one_hot``: a label
    outside ``[0, C)`` gives an all-zero column, as ``jax.nn.one_hot`` does,
    where ``F.one_hot`` would raise.
    """
    if num_classes is None:
        num_classes = int(label_tensor.max()) + 1
    classes = torch.arange(num_classes, device=label_tensor.device)
    classes = classes.reshape((1, num_classes) + (1,) * (label_tensor.ndim - 1))
    return (label_tensor.unsqueeze(1) == classes).to(torch.int32)


_SAME_WIDTH_INT = {
    torch.float64: torch.int64,
    torch.float32: torch.int32,
    torch.bfloat16: torch.int16,
    torch.float16: torch.int16,
}


def _total_order_keys(x: torch.Tensor) -> torch.Tensor:
    """Integers that order the floats of ``x`` as IEEE-754 totalOrder, as ``lax.top_k`` does.

    A NaN with the sign bit clear ranks above ``+inf``, one with it set below
    ``-inf``, and ``-0.0`` below ``+0.0``; ``argmax`` and ``topk`` would tie the
    zeros and rank every NaN first.
    """
    bits = x.view(_SAME_WIDTH_INT[x.dtype])
    width = bits.element_size() * 8
    return bits ^ ((bits >> (width - 1)) & ((1 << (width - 1)) - 1))


def select_topk(prob_tensor: torch.Tensor, topk: int = 1, dim: int = 1) -> torch.Tensor:
    """int32 mask of the top-k entries along ``dim``, the entries ``lax.top_k`` picks.

    Entries rank by :func:`_total_order_keys` and ties go to the lower index:
    ``k == 1`` is an ``argmax`` of the keys (the first of tied maxima), ``k > 1``
    a stable descending sort (``torch.topk`` leaves the order of ties unspecified).
    """
    keys = _total_order_keys(prob_tensor)
    if topk == 1:
        idx = keys.argmax(dim=dim, keepdim=True)
    else:
        idx = keys.sort(dim=dim, descending=True, stable=True).indices.narrow(dim, 0, topk)
    mask = torch.zeros_like(prob_tensor, dtype=torch.int32)
    return mask.scatter_(dim, idx, 1)


def _bincount(x: torch.Tensor, minlength: int) -> torch.Tensor:
    """Fixed-length int32 bincount with the semantics of ``jnp.bincount(x, length=...)``:
    negative values count in bin 0 and values past the end are dropped."""
    counts = torch.bincount(x.reshape(-1).clamp(min=0), minlength=minlength)
    return counts[:minlength].to(torch.int32)


def _confusion_counts(preds: torch.Tensor, target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Pairwise label-confusion counts ``(C, C)`` in ``[target, pred]`` order.

    The JAX package forms this as an int8 one-hot matmul for the TPU's matrix
    unit; on the GPU it is a histogram over ``target * C + pred``.
    """
    preds = preds.reshape(-1)
    target = target.reshape(-1)
    return _bincount(target * num_classes + preds, minlength=num_classes**2).reshape(
        num_classes, num_classes
    )


def _linspace_thresholds(num: int) -> np.ndarray:
    """``jnp.linspace(0, 1.0, num)`` bit for bit: XLA multiplies ``iota(num - 1)`` by
    the float32 reciprocal of ``num - 1`` and appends the end point 1.0 (a division,
    or that product at the last point, differs from it in the last bit)."""
    if num == 1:
        return np.zeros(1, np.float32)
    step = np.float32(1) / np.float32(num - 1)
    return np.concatenate([np.arange(num - 1, dtype=np.float32) * step, np.ones(1, np.float32)])


def _squeeze_if_scalar(data: Any) -> Any:
    """Squeeze every one-element tensor in a (nested) result to 0-d."""
    if isinstance(data, torch.Tensor):
        return data.squeeze() if data.numel() == 1 and data.ndim > 0 else data
    if isinstance(data, dict):
        return {k: _squeeze_if_scalar(v) for k, v in data.items()}
    if isinstance(data, (list, tuple)):
        return type(data)(_squeeze_if_scalar(v) for v in data)
    return data


def allclose(a: torch.Tensor, b: torch.Tensor, rtol: float = 1e-5, atol: float = 1e-8) -> bool:
    if a.shape != b.shape:
        return False
    if a.is_floating_point() or b.is_floating_point():
        return bool(torch.allclose(a.double(), b.double(), rtol=rtol, atol=atol))
    return bool(torch.equal(a, b.to(a.dtype)))
