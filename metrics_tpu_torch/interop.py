"""Carry a metric's state across from the JAX package.

:func:`load_jax_state` takes what ``metrics_tpu.Metric.state_pytree()`` or
``.state_dict()`` returns (arrays, read here through ``numpy.asarray``) and
what ``._ckpt_extra_state()`` returns (plain JSON), and loads them into the
matching metric of this package.  It needs neither JAX nor the JAX package.
:func:`inception_state_dict_from_flax` and :func:`lpips_state_dict_from_flax`
carry the image extractors' weights across (they are weights, not states).
The two wrappers that carry more than their base metric's state,
``BootStrapper`` and ``MinMaxMetric``, take a dict of their parts (see
:func:`load_jax_state`).
"""

from typing import Any, Dict, Optional

import numpy as np
import torch

from metrics_tpu_torch.detection import MeanAveragePrecision
from metrics_tpu_torch.image.backbones.convert import (  # noqa: F401  (re-exported: the extractors' weights)
    inception_state_dict_from_flax,
    lpips_state_dict_from_flax,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.wrappers import BootStrapper, MinMaxMetric


def _as_numpy(value: Any, name: str, metric: Optional[Metric]) -> Any:
    """A host copy of one state's value; with ``metric``, checked against what that tensor state may hold."""
    if isinstance(value, (list, tuple)):
        return [_as_numpy(v, name, None) for v in value]
    array = np.array(value)  # a writable host copy
    if metric is not None:
        default = metric._defaults[name]
        expected = str(default.dtype).replace("torch.", "")
        if array.dtype.name != expected or not metric._holds_shape(name, array.shape):
            widened = " or a shape its update widens it to" if metric._widen_ndim.get(name, 0) != 0 else ""
            raise ValueError(
                f"state {name!r}: got {array.dtype.name}{list(array.shape)}, "
                f"the metric holds {expected}{list(default.shape)}{widened}"
            )
    return array


def load_jax_state(metric: Metric, state: Dict[str, Any], extra: Optional[Dict[str, Any]] = None) -> None:
    """Load a JAX metric's state (and its checkpoint extras) into ``metric``.

    Every state lands on ``metric.device`` with its dtype kept; a tensor
    state whose dtype differs from the metric's own raises, and so does one
    of a shape the metric could never hold (its default's shape, or one its
    update may widen a scalar to: ``Metric.add_state(widen_ndim=)``).  A
    buffer state's ``<name>__buf`` may hold any number of rows (trimmed, as
    ``state_pytree`` gives it, or padded, as ``state_dict`` does) and any
    dtype; its ``<name>__len`` says how many are valid.
    ``_update_count``, where ``state`` carries it, and the attributes in
    ``extra`` (such as the locked classification ``mode``) are restored too.
    Sketch leaves (``<name>__sk_<leaf>``, the PRNG key a ``uint32`` ``(2,)``)
    and a ``WindowedMetric``'s rings (``wb_*``, ``w__ptr``, ``w__count``) load
    as tensor states, so a sketch loaded mid-stream continues bit for bit as
    it would have in the JAX package: its coin flips come from the key.
    A ``MultiStreamMetric``'s stacked states (``(S, ...)`` tensors and
    stacked sketch leaves, ``stream_rows``, ``stream_dropped``) load the same
    way; its ``extra`` carries the base's under ``"base"`` (such as the
    locked ``mode``), as the JAX package's ``_ckpt_extra_state()`` gives it.

    A ``BootStrapper``'s ``state`` holds ``_update_count``, ``rng`` (the JAX
    wrapper's ``_rng.bit_generator.state``: the draws continue where its
    draws stopped), ``_replica_rows`` (or None), and its copies' states:
    ``_stacked_state`` (each state stacked along a leading copy axis, as the
    JAX package holds the copies it updates as one) where that is not None,
    else ``replicas``, each copy's ``state_pytree()``.  Its ``extra`` is a
    list of the copies' ``_ckpt_extra_state()`` or one dict for all.  A
    ``MinMaxMetric``'s ``state`` holds ``_update_count``, ``min_val``,
    ``max_val`` and ``base``, the base metric's ``state_pytree()``; its
    ``extra`` is the base metric's.

    A ``MeanAveragePrecision``'s ``extra`` may carry the JAX metric's route
    flag under its JAX name, ``device`` (``None``, ``True`` or ``False``):
    it sets ``on_device``, since ``device`` here names the torch device.
    """
    if isinstance(metric, BootStrapper):
        _load_bootstrapper(metric, state, extra)
        return
    if isinstance(metric, MinMaxMetric):
        metric._update_count = int(state["_update_count"])
        metric._computed = None
        metric.min_val = torch.as_tensor(np.array(state["min_val"]), dtype=torch.float32, device=metric.device)
        metric.max_val = torch.as_tensor(np.array(state["max_val"]), dtype=torch.float32, device=metric.device)
        load_jax_state(metric._base_metric, state["base"], extra)
        return
    if extra and "device" in extra and isinstance(metric, MeanAveragePrecision):
        extra = dict(extra)
        route = extra.pop("device")
        if route is not None and not isinstance(route, bool):
            raise ValueError(f"the JAX MeanAveragePrecision's `device` is a bool or None, got {route!r}")
        metric.on_device = route
    tree: Dict[str, Any] = {}
    for name, value in state.items():
        if name == "_update_count":
            tree[name] = int(value)
            continue
        if name not in metric._defaults:
            raise KeyError(f"{type(metric).__name__} has no state {name!r}")
        # a buffer's rows grow with the stream, and a list state's entries with it:
        # neither has a default that fixes a shape
        checked = name not in metric._buffer_keys() and not isinstance(metric._defaults[name], list)
        tree[name] = _as_numpy(value, name, metric if checked else None)
    if "_update_count" not in tree:
        tree["_update_count"] = metric._update_count
    metric.load_state_pytree(tree)
    if extra:
        metric._ckpt_load_extra_state(extra)


def _load_bootstrapper(metric: BootStrapper, state: Dict[str, Any], extra: Any) -> None:
    count = int(state["_update_count"])
    rows = state.get("_replica_rows")
    rows = None if rows is None else np.array(rows, dtype=np.int64)
    stacked = state.get("_stacked_state")
    extras = extra if isinstance(extra, list) else [extra] * metric.num_bootstraps
    for i, copy in enumerate(metric.metrics):
        if stacked is not None:
            fed = rows is None or rows[i] > 0
            tree = {name: np.asarray(value)[i] for name, value in stacked.items()}
            tree["_update_count"] = count if fed else 0
        else:
            tree = state["replicas"][i]
        load_jax_state(copy, tree, extras[i])
    metric._update_count = count
    metric._computed = None
    metric._replica_rows = rows
    metric._stacked = True if stacked is not None else None
    metric._rng = np.random.default_rng()
    metric._rng.bit_generator.state = state["rng"]
