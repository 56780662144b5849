"""Data / reduction helpers (counterpart of ``metrics_tpu/utils/data.py``)."""

from typing import Any, Dict, List, Optional, Union

import torch


def dim_zero_cat(x: Union[torch.Tensor, List[torch.Tensor], tuple]) -> torch.Tensor:
    """Concatenate a list state along dim 0 (identity on a lone tensor)."""
    if not isinstance(x, (list, tuple)):
        return x
    if len(x) == 0:
        raise ValueError("No samples to concatenate")
    return torch.cat([torch.atleast_1d(v) for v in x], dim=0)


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


def select_topk(prob_tensor: torch.Tensor, topk: int = 1, dim: int = 1) -> torch.Tensor:
    """int32 mask of the top-k entries along ``dim``.

    ``k == 1`` takes ``argmax``, which picks the first of tied maxima as
    ``lax.top_k`` does; ``torch.topk`` leaves the order of ties unspecified.
    """
    if topk == 1:
        idx = prob_tensor.argmax(dim=dim, keepdim=True)
    else:
        idx = prob_tensor.topk(topk, dim=dim).indices
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
