"""Data / reduction helpers (counterpart of ``metrics_tpu/utils/data.py``)."""

from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from metrics_tpu_torch.utils.compute import _mean


def dim_zero_cat(x: Union[torch.Tensor, List[torch.Tensor], tuple]) -> torch.Tensor:
    """Concatenate a list state along dim 0 (identity on a lone tensor)."""
    if not isinstance(x, (list, tuple)):
        return x
    if len(x) == 0:
        raise ValueError("No samples to concatenate")
    return torch.cat([torch.atleast_1d(v) for v in x], dim=0)


def reduce(x: torch.Tensor, reduction: Optional[str] = "elementwise_mean") -> torch.Tensor:
    """Reduce a score tensor: its mean (``elementwise_mean``), its sum, or itself (``none``/``None``)."""
    if reduction == "elementwise_mean":
        return _mean(x)
    if reduction == "sum":
        return x.sum()
    if reduction is None or reduction == "none":
        return x
    raise ValueError("Reduction parameter unknown.")


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


def to_categorical(x: torch.Tensor, argmax_dim: int = 1) -> torch.Tensor:
    """Probabilities or one-hots to dense int64 labels: the argmax along ``argmax_dim``.

    Ties go to the first index and a NaN counts as the maximum (the first NaN
    wins), as in ``jnp.argmax``; the JAX package's labels are int32.
    """
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)  # argmax takes no bool input
    return torch.argmax(x, dim=argmax_dim)


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


def apply_to_collection(data: Any, dtype: Union[type, tuple], function: Callable, *args: Any, **kwargs: Any) -> Any:
    """Apply ``function`` to every element of type ``dtype`` in nested lists, tuples and dicts.

    A tuple keeps its type, a list comes back a list, a dict a dict; anything
    else that is not a ``dtype`` comes back as it is.
    """
    if isinstance(data, dtype):
        return function(data, *args, **kwargs)
    if isinstance(data, (list, tuple)):
        out = [apply_to_collection(d, dtype, function, *args, **kwargs) for d in data]
        return type(data)(out) if isinstance(data, tuple) else out
    if isinstance(data, dict):
        return {k: apply_to_collection(v, dtype, function, *args, **kwargs) for k, v in data.items()}
    return data


def get_group_indexes(indexes: Union[torch.Tensor, np.ndarray]) -> List[torch.Tensor]:
    """The row positions of each query id, one int64 tensor per id in order of first appearance.

    A host helper: the ids come to the host in one copy, and the positions go
    back to the input's device in one copy, split into views per id.
    """
    device = indexes.device if isinstance(indexes, torch.Tensor) else torch.device("cpu")
    host = indexes.cpu().numpy() if isinstance(indexes, torch.Tensor) else np.asarray(indexes)
    groups: Dict[Any, List[int]] = {}
    for i, idx in enumerate(host.reshape(-1).tolist()):
        groups.setdefault(idx, []).append(i)
    if not groups:
        return []
    positions = torch.from_numpy(np.concatenate([np.asarray(v, dtype=np.int64) for v in groups.values()]))
    return list(torch.split(positions.to(device), [len(v) for v in groups.values()]))


def class_reduce(
    num: torch.Tensor, denom: torch.Tensor, weights: torch.Tensor, class_reduction: Optional[str] = "none"
) -> torch.Tensor:
    """Reduce per-class fractions ``num / denom``: ``micro`` (the sums' quotient), ``macro``
    (the mean fraction), ``weighted`` (by ``weights`` over their sum) or ``none``/``None``
    (the fractions).

    A class with ``denom == 0`` counts 0 when ``num == 0`` and the float32
    extreme of the sign of ``num`` otherwise, as ``jnp.nan_to_num`` has them.
    Integer counts divide to float32.
    """
    valid_reduction = ("micro", "macro", "weighted", "none", None)
    if class_reduction == "micro":
        return torch.nan_to_num(num.sum() / denom.sum())
    fraction = torch.nan_to_num(num / denom)
    if class_reduction == "macro":
        return _mean(fraction)
    if class_reduction == "weighted":
        w = weights.to(torch.float32)
        return torch.sum(fraction * (w / w.sum()))
    if class_reduction in ("none", None):
        return fraction
    raise ValueError(
        f"Reduction parameter {class_reduction} unknown. Choose between one of these: {valid_reduction}"
    )


def allclose(a: torch.Tensor, b: torch.Tensor, rtol: float = 1e-5, atol: float = 1e-8) -> bool:
    if a.shape != b.shape:
        return False
    if a.is_floating_point() or b.is_floating_point():
        return bool(torch.allclose(a.double(), b.double(), rtol=rtol, atol=atol))
    return bool(torch.equal(a, b.to(a.dtype)))
