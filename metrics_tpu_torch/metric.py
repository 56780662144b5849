"""Core ``Metric`` runtime, single process (counterpart of ``metrics_tpu/metric.py``).

A metric is a ``torch.nn.Module``.  Its streaming states are tensors (or
Python lists of tensors for ``cat`` states) held as plain attributes and
registered with :meth:`Metric.add_state`; subclasses write ``update`` and
``compute`` over them.  Every state lives on the metric's ``device``, fixed at
construction, and an input on another device raises.

States are replaced, never written in place (``self.tp = self.tp + tp``),
and :meth:`Metric.reset` installs clones of the defaults: so a value that
``compute`` returned, a ``forward`` snapshot, a compute group's shared
tensors and the stored defaults never alias a tensor that a later update
changes.  A subclass must keep to that style.
"""

import copy
import inspect
import numbers
from abc import ABC, abstractmethod
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from metrics_tpu_torch.utils.data import _squeeze_if_scalar, dim_zero_cat
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from metrics_tpu_torch.utils.prints import rank_zero_warn

_ALLOWED_REDUCE = ("sum", "mean", "max", "min", "cat")


def _resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device a metric keeps its state on; CUDA must be present when asked for."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to keep the metric's state on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"metrics run on 'cuda' or 'cpu', got {device}")
    return device


def _merge_tensor_state(fx: Any, global_val: torch.Tensor, local_val: torch.Tensor, global_count: int) -> torch.Tensor:
    """O(1) merge of one tensor state in the forward fast path."""
    if fx == "sum":
        return global_val + local_val
    if fx == "mean":
        return (global_count * global_val + local_val) / (global_count + 1)
    if fx == "max":
        return torch.maximum(global_val, local_val)
    if fx == "min":
        return torch.minimum(global_val, local_val)
    raise MetricsTPUUserError(f"cannot fast-merge a state with reduce {fx!r}")


def _to_state_tensor(value: Any, device: torch.device) -> torch.Tensor:
    """A tensor, numpy array or number as a state tensor on ``device``.

    Python numbers take the JAX package's dtypes (int32, float32), numpy
    arrays and tensors keep theirs.
    """
    if isinstance(value, bool):
        return torch.tensor(value, dtype=torch.bool, device=device)
    if isinstance(value, numbers.Integral):
        return torch.tensor(value, dtype=torch.int32, device=device)
    if isinstance(value, numbers.Real):
        return torch.tensor(value, dtype=torch.float32, device=device)
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(np.array(value))  # a writable copy
    if not isinstance(value, torch.Tensor):
        raise ValueError("state values must be tensors, numpy arrays or numbers")
    return value.to(device)


class Metric(nn.Module, ABC):
    """Base class for all metrics.

    Subclasses implement :meth:`update` and :meth:`compute`, registering
    streaming state in ``__init__`` via :meth:`add_state`.

    Args (keyword-only, collected in ``**kwargs``):
        device: where the states live, ``"cuda"`` (the default) or ``"cpu"``.
            Construction raises when CUDA is asked for and absent.
        sync_on_compute: synchronize before ``compute`` (default True).
            Cross-process sync is not part of this package yet: with a
            ``torch.distributed`` process group initialised, a sync raises.

    ``compute`` returns its cached value until the next update or reset.
    """

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = False

    # python attributes determined at runtime from the data (e.g. the
    # classification input `mode` locked on the first update) that a
    # checkpoint restore must bring back for compute() to work; values must
    # be JSON-serializable or EnumStr members
    _ckpt_attrs: Tuple[str, ...] = ()

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self.device = _resolve_device(kwargs.pop("device", "cuda"))
        self.sync_on_compute = kwargs.pop("sync_on_compute", True)
        if kwargs:
            raise ValueError(f"Unexpected keyword arguments: {sorted(kwargs)}")
        self._defaults: Dict[str, Any] = {}
        self._reduce_fns: Dict[str, Any] = {}
        self._persistent: Dict[str, bool] = {}
        self._update_count = 0
        self._computed: Any = None
        self._is_synced = False
        self._cache: Optional[Dict[str, Any]] = None
        self._cached_count = 0
        self._update_called_warned = False
        self._install_wrappers()

    def _install_wrappers(self) -> None:
        """Shadow ``update``/``compute`` with the runtime wrappers, per instance,
        so ``super().update(...)`` calls stay raw and subclass overrides are wrapped."""
        object.__setattr__(self, "_update_impl", type(self).update.__get__(self))
        object.__setattr__(self, "_compute_impl", type(self).compute.__get__(self))
        object.__setattr__(self, "update", self._update_wrapper)
        object.__setattr__(self, "compute", self._compute_wrapper)

    # ------------------------------------------------------------------ state
    def add_state(
        self,
        name: str,
        default: Any,
        dist_reduce_fx: Optional[Union[str, Callable]] = None,
        persistent: bool = False,
    ) -> None:
        """Register a streaming state.

        ``default`` is a tensor, numpy array or number (tensor state, fixed
        shape) or an empty Python list (list state, gathered with ``cat``
        semantics).
        """
        if isinstance(dist_reduce_fx, str):
            if dist_reduce_fx not in _ALLOWED_REDUCE:
                raise ValueError(f"`dist_reduce_fx` must be one of {_ALLOWED_REDUCE}, callable or None")
        elif dist_reduce_fx is not None and not callable(dist_reduce_fx):
            raise ValueError("`dist_reduce_fx` must be a str, callable or None")
        if isinstance(default, list):
            if default:
                raise ValueError("list states must default to the empty list")
        elif isinstance(default, (torch.Tensor, np.ndarray, numbers.Number)):
            default = _to_state_tensor(default, self.device)
        else:
            raise ValueError("state default must be a tensor, an array, a number, or an empty list")
        if not name.isidentifier():
            raise ValueError(f"state name must be a valid identifier, got {name!r}")
        self._defaults[name] = default
        self._reduce_fns[name] = dist_reduce_fx
        self._persistent[name] = persistent
        setattr(self, name, [] if isinstance(default, list) else default.clone())

    @property
    def update_count(self) -> int:
        return self._update_count

    def _copy_state(self) -> Dict[str, Any]:
        """A snapshot of the states: updates rebind tensors, so references suffice."""
        out: Dict[str, Any] = {}
        for name in self._defaults:
            value = getattr(self, name)
            out[name] = list(value) if isinstance(value, list) else value
        return out

    def _restore_state(self, cache: Dict[str, Any]) -> None:
        for name, value in cache.items():
            setattr(self, name, list(value) if isinstance(value, list) else value)

    # ----------------------------------------------------------------- update
    @abstractmethod
    def update(self, *args: Any, **kwargs: Any) -> None:
        """Fold a batch into state."""

    @abstractmethod
    def compute(self) -> Any:
        """Compute the final value from (synced) state."""

    def _pre_update(self, *args: Any, **kwargs: Any) -> None:
        """Hook run on the inputs before each update (classification locks its input case here)."""

    def _check_input_devices(self, args: tuple, kwargs: dict) -> None:
        for value in (*args, *kwargs.values()):
            if isinstance(value, torch.Tensor):
                where = value.device
            elif isinstance(value, np.ndarray):
                where = torch.device("cpu")
            else:
                continue
            if where != self.device:
                raise RuntimeError(
                    f"{type(self).__name__} keeps its state on {self.device} but got an input on {where}"
                )

    def _update_wrapper(self, *args: Any, **kwargs: Any) -> None:
        if self._is_synced:
            raise MetricsTPUUserError(
                "The Metric has already been synced; re-syncing or updating while synced is forbidden."
            )
        self._check_input_devices(args, kwargs)
        self._pre_update(*args, **kwargs)
        self._computed = None
        self._update_count += 1
        self._update_impl(*args, **kwargs)

    def update_batched(self, *args: Any, **kwargs: Any) -> None:
        """Fold a stack of batches: one :meth:`update` per slice of the leading axis.

        Every tensor or array argument must carry the same leading
        ``n_batches`` axis; other arguments pass unchanged to every slice.
        """
        def batched(x: Any) -> bool:
            return isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim >= 1

        sizes = sorted({x.shape[0] for x in (*args, *kwargs.values()) if batched(x)})
        if not sizes:
            raise MetricsTPUUserError("update_batched needs array inputs with a leading n_batches axis")
        if len(sizes) > 1:
            raise MetricsTPUUserError(
                "update_batched: all array inputs must share the leading n_batches axis; "
                f"got sizes {sizes}"
            )
        for i in range(sizes[0]):
            self.update(
                *(x[i] if batched(x) else x for x in args),
                **{k: v[i] if batched(v) else v for k, v in kwargs.items()},
            )

    # ---------------------------------------------------------------- forward
    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Update global state AND return the metric on this batch alone.

        The fast path merges the pre-update state with the batch state
        through the per-state reductions; the full path re-runs update on
        the cached global state.
        """
        if self._is_synced:
            raise MetricsTPUUserError("Calling forward while the metric is synced is forbidden.")
        # custom callables and None-reduce *tensor* states have no O(1) merge
        # rule — route them through the full re-update path
        no_fast_merge = any(
            callable(fx) or (fx is None and not isinstance(getattr(self, name), list))
            for name, fx in self._reduce_fns.items()
        )
        if self.full_state_update or no_fast_merge:
            return self._forward_full_state_update(*args, **kwargs)
        return self._forward_reduce_state_update(*args, **kwargs)

    def _batch_value(self, *args: Any, **kwargs: Any) -> Any:
        """Reset, update on this batch alone and compute, without a sync."""
        self.reset()
        self.update(*args, **kwargs)
        prev_sync = self.sync_on_compute
        self.sync_on_compute = False
        try:
            return self.compute()
        finally:
            self.sync_on_compute = prev_sync

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        self.update(*args, **kwargs)
        cache = self._copy_state()
        cached_count = self._update_count
        batch_val = self._batch_value(*args, **kwargs)
        self._restore_state(cache)
        self._update_count = cached_count
        self._computed = None
        self._is_synced = False
        return batch_val

    def _forward_reduce_state_update(self, *args: Any, **kwargs: Any) -> Any:
        global_state = self._copy_state()
        global_count = self._update_count
        batch_val = self._batch_value(*args, **kwargs)
        self._reduce_states(global_state, global_count)
        self._update_count = global_count + 1
        self._computed = None
        self._is_synced = False
        return batch_val

    def _reduce_states(self, global_state: Dict[str, Any], global_count: int) -> None:
        """Merge the pre-update state with the batch state now held by the metric."""
        for name, global_val in global_state.items():
            local_val = getattr(self, name)
            fx = self._reduce_fns[name]
            if isinstance(global_val, list):
                merged: Any = list(global_val) + list(local_val)
            elif fx == "cat" or fx is None:
                merged = torch.cat([torch.atleast_1d(global_val), torch.atleast_1d(local_val)], dim=0)
            else:
                merged = _merge_tensor_state(fx, global_val, local_val, global_count)
            setattr(self, name, merged)

    # ------------------------------------------------------------------- sync
    def sync(self, should_sync: bool = True) -> None:
        """Mark the state synced, caching the local state for :meth:`unsync`.

        Within one process there is nothing to gather.  Cross-process sync
        over ``torch.distributed`` is a later part of the port: with a
        process group initialised, a sync raises rather than computing on
        the local state alone.
        """
        if self._is_synced:
            raise MetricsTPUUserError("The Metric has already been synced.")
        if should_sync and dist.is_available() and dist.is_initialized():
            raise NotImplementedError(
                "cross-process metric sync over torch.distributed is not ported yet; "
                "pass sync_on_compute=False to compute on this process's state alone"
            )
        self._cache = self._copy_state()
        self._cached_count = self._update_count
        self._is_synced = True

    def unsync(self, should_unsync: bool = True) -> None:
        """Restore the pre-sync local state."""
        if not should_unsync:
            return
        if not self._is_synced:
            raise MetricsTPUUserError("The Metric has already been un-synced.")
        if self._cache is None:
            raise MetricsTPUUserError("The internal cache should exist to unsync the Metric.")
        self._restore_state(self._cache)
        self._update_count = self._cached_count
        self._is_synced = False
        self._cache = None

    @contextmanager
    def sync_context(self, should_sync: bool = True, should_unsync: bool = True) -> Iterator["Metric"]:
        self.sync(should_sync=should_sync)
        try:
            yield self
        finally:
            self.unsync(should_unsync=should_unsync and self._is_synced)

    # ---------------------------------------------------------------- compute
    def _compute_wrapper(self) -> Any:
        if self._update_count == 0 and not self._update_called_warned:
            rank_zero_warn(
                f"The ``compute`` method of metric {type(self).__name__} was called before the "
                "``update`` method; this will lead to errors or nonsense values.",
                UserWarning,
            )
            self._update_called_warned = True
        if self._computed is not None:
            return self._computed
        with self.sync_context(should_sync=self.sync_on_compute):
            self._computed = _squeeze_if_scalar(self._compute_impl())
        return self._computed

    # ------------------------------------------------------------------ reset
    def reset(self) -> None:
        """Reset state to fresh copies of the defaults."""
        self._update_count = 0
        self._computed = None
        self._cache = None
        self._is_synced = False
        for name, default in self._defaults.items():
            setattr(self, name, [] if isinstance(default, list) else default.clone())

    def clone(self) -> "Metric":
        return copy.deepcopy(self)

    # ------------------------------------------------------------ persistence
    def persistent(self, mode: bool = False) -> None:
        for name in self._persistent:
            self._persistent[name] = mode

    def _save_to_state_dict(self, destination: Dict[str, Any], prefix: str, keep_vars: bool) -> None:
        """Add the persistent states to ``state_dict()``."""
        super()._save_to_state_dict(destination, prefix, keep_vars)
        for name in self._defaults:
            if not self._persistent[name]:
                continue
            value = getattr(self, name)
            if isinstance(value, list):
                destination[prefix + name] = [v if keep_vars else v.detach().clone() for v in value]
            else:
                destination[prefix + name] = value if keep_vars else value.detach().clone()

    def _load_from_state_dict(
        self,
        state_dict: Dict[str, Any],
        prefix: str,
        local_metadata: Dict[str, Any],
        strict: bool,
        missing_keys: List[str],
        unexpected_keys: List[str],
        error_msgs: List[str],
    ) -> None:
        """Load states from ``load_state_dict``: tensors or numpy arrays, dtypes kept."""
        self._computed = None  # a cached compute() predates the loaded state
        for name in self._defaults:
            key = prefix + name
            if key in state_dict:
                value = state_dict.pop(key)
                if isinstance(value, list):
                    setattr(self, name, [_to_state_tensor(v, self.device) for v in value])
                else:
                    setattr(self, name, _to_state_tensor(value, self.device))
        super()._load_from_state_dict(
            state_dict, prefix, local_metadata, strict, missing_keys, unexpected_keys, error_msgs
        )

    def _ckpt_extra_state(self) -> Dict[str, Any]:
        """JSON-serializable non-state attrs to ride along in a checkpoint."""
        from enum import Enum

        out: Dict[str, Any] = {}
        for attr in self._ckpt_attrs:
            value = getattr(self, attr, None)
            if isinstance(value, Enum):
                value = {"__enum__": type(value).__name__, "value": value.value}
            out[attr] = value
        return out

    def _ckpt_load_extra_state(self, extra: Dict[str, Any]) -> None:
        from metrics_tpu_torch.utils import enums as _enums

        for attr, value in extra.items():
            if attr not in self._ckpt_attrs:
                continue  # checkpoint from an older schema
            if isinstance(value, dict) and "__enum__" in value:
                enum_cls = getattr(_enums, value["__enum__"], None)
                value = enum_cls(value["value"]) if enum_cls is not None else value["value"]
            setattr(self, attr, value)

    def state_pytree(self) -> Dict[str, Any]:
        """The full state as a flat dict: ``_update_count`` and every state,
        list states concatenated."""
        out: Dict[str, Any] = {"_update_count": self._update_count}
        for name in self._defaults:
            value = getattr(self, name)
            out[name] = dim_zero_cat(value) if isinstance(value, list) and value else value
        return out

    def load_state_pytree(self, tree: Dict[str, Any]) -> None:
        """Load what :meth:`state_pytree` returns (tensors or numpy arrays) onto this metric's device."""
        tree = dict(tree)
        self._computed = None  # a cached compute() predates the loaded state
        self._update_count = int(tree.pop("_update_count", 0))
        for name, value in tree.items():
            if name not in self._defaults:
                raise KeyError(f"unknown state {name!r}")
            if isinstance(value, list):
                setattr(self, name, [_to_state_tensor(v, self.device) for v in value])
            elif isinstance(self._defaults[name], list):
                setattr(self, name, [_to_state_tensor(value, self.device)])
            else:
                setattr(self, name, _to_state_tensor(value, self.device))

    # -------------------------------------------------------------- pickling
    def __getstate__(self) -> Dict[str, Any]:
        d = self.__dict__.copy()
        # bound-method wrappers are reinstalled in __setstate__
        for key in ("update", "compute", "_update_impl", "_compute_impl"):
            d.pop(key, None)
        d["_cache"] = None
        d["_computed"] = None
        return d

    def __setstate__(self, d: Dict[str, Any]) -> None:
        super().__setstate__(d)
        self._install_wrappers()

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """Keep only the kwargs the update signature accepts."""
        params = inspect.signature(self._update_impl).parameters
        if any(p.kind == p.VAR_KEYWORD for p in params.values()):
            return kwargs
        return {k: v for k, v in kwargs.items() if k in params}
