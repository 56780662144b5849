"""Core ``Metric`` runtime (counterpart of ``metrics_tpu/metric.py``).

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

Buffer states (:meth:`Metric.add_buffer_state`) are the one exception: rows
are appended in place into a padded ``<name>__buf`` past its ``<name>__len``
valid rows, and only by the metric that allocated that buffer.  A snapshot
sees rows ``[:len]``, which later appends never touch; a metric that holds a
buffer it did not allocate (a compute-group member, a loaded or synced
state) copies it before its first append.

``compute`` syncs the states across processes first when a
``torch.distributed`` process group of more than one rank is initialised
(or an explicit ``sync_backend`` is given): a schema preflight, then one
packed blob gather, reduced in rank order on every rank; ``unsync`` restores
the local state after.  See :mod:`metrics_tpu_torch.parallel`.
"""

import copy
import hashlib
import inspect
import numbers
import os
import struct
import time
from abc import ABC, abstractmethod
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from metrics_tpu_torch.parallel.backend import (
    Backend,
    SyncOptions,
    get_backend,
    reduce_stack,
    reduce_synced_state,
)
from metrics_tpu_torch.utils.data import _squeeze_if_scalar, _x32, _x32_dtype, dim_zero_cat
from metrics_tpu_torch.utils.exceptions import (
    MetricsTPUUserError,
    SyncError,
    SyncIntegrityError,
    SyncTimeoutError,
)
from metrics_tpu_torch.utils.prints import rank_zero_warn

_ALLOWED_REDUCE = ("sum", "mean", "max", "min", "cat")

_UNSET = object()  # sentinel: distinguish "no saved value" from a None value


def _rows_of(x: torch.Tensor) -> int:
    """Leading-axis row count under ``dim_zero_cat`` semantics (0-d == 1 row)."""
    return int(x.shape[0]) if x.ndim >= 1 else 1


def _dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype by its numpy name (``int32``, ``bfloat16``, ``bool``), as the JAX package prints dtypes."""
    return str(dtype).replace("torch.", "")


class _DeltaCache:
    """Per-metric cache of the previously gathered cat/list state.

    ``prefixes[name]`` holds the last globally gathered value of a cat-like
    state (identical on every rank), ``watermarks[name]`` the number of local
    rows that prefix covers on this rank.  A sync with a live cache gathers
    only the rows past the watermark and splices them onto the prefix, so a
    K-step streaming sync loop ships O(K) bytes, not O(K²).

    ``round`` encodes trust: ``0`` means no verified prefix (the next sync is
    a full gather); ``N >= 1`` means the prefix came out of round N and every
    rank that agrees on ``N`` holds the identical prefix.  The preflight vote
    compares ``(round, digest(state names))`` across ranks; any disagreement,
    or any rank with a cleared cache, forces every rank back to a full gather.

    Compute-group members of a :class:`MetricCollection` alias one cache
    object, which is why :meth:`clear` empties in place rather than rebinding.
    """

    def __init__(self) -> None:
        self.prefixes: Dict[str, Optional[torch.Tensor]] = {}
        self.watermarks: Dict[str, int] = {}
        self.round = 0

    def clear(self) -> None:
        self.prefixes.clear()
        self.watermarks.clear()
        self.round = 0

    def token(self, names: Sequence[str]) -> Tuple[int, int, int]:
        """``(round, digest_lo, digest_hi)`` int32-safe vote token over the
        participating state names (watermarks differ across uneven shards)."""
        h = hashlib.blake2b("\x1f".join(sorted(names)).encode(), digest_size=8).digest()
        lo = int.from_bytes(h[:4], "little") & 0x7FFFFFFF
        hi = int.from_bytes(h[4:], "little") & 0x7FFFFFFF
        return (self.round & 0x7FFFFFFF, lo, hi)


def _pack_state_blob(arrays: Dict[str, torch.Tensor]) -> bytes:
    """Serialize named tensors into one self-describing blob.

    Byte for byte the JAX package's format: a little-endian count, then per
    key in sorted order its name, numpy dtype name, shape and C-order bytes.
    """
    parts = [struct.pack("<I", len(arrays))]
    for key in sorted(arrays):
        t = arrays[key].detach().cpu().contiguous()
        # bfloat16 has no numpy dtype without ml_dtypes: ship its raw 2-byte words
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        kb, db = key.encode(), _dtype_name(t.dtype).encode()
        parts.append(struct.pack("<HHB", len(kb), len(db), t.ndim))
        parts.append(kb)
        parts.append(db)
        parts.append(struct.pack(f"<{t.ndim}q", *t.shape))
        parts.append(struct.pack("<q", len(raw)))
        parts.append(raw)
    return b"".join(parts)


def _unpack_state_blob(blob: bytes) -> Dict[str, torch.Tensor]:
    """The named CPU tensors of a blob from :func:`_pack_state_blob`."""
    out: Dict[str, torch.Tensor] = {}
    off = 4
    (n,) = struct.unpack_from("<I", blob, 0)
    for _ in range(n):
        klen, dlen, ndim = struct.unpack_from("<HHB", blob, off)
        off += 5
        key = blob[off : off + klen].decode()
        off += klen
        name = blob[off : off + dlen].decode()
        off += dlen
        shape = struct.unpack_from(f"<{ndim}q", blob, off)
        off += 8 * ndim
        (nbytes,) = struct.unpack_from("<q", blob, off)
        off += 8
        dt = np.dtype(np.int16) if name == "bfloat16" else np.dtype(name)
        arr = np.frombuffer(blob, dt, count=nbytes // dt.itemsize, offset=off).reshape(shape)
        tensor = torch.from_numpy(arr.copy())
        out[key] = tensor.view(torch.bfloat16) if name == "bfloat16" else tensor
        off += nbytes
    return out


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


def _grown_capacity(capacity: int, rows: int) -> int:
    """``capacity`` (at least 1) doubled until it holds ``rows``."""
    cap = max(capacity, 1)
    while cap < rows:
        cap *= 2
    return cap


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
        dist_sync_on_step: sync the batch state in every ``forward`` so its
            value covers every rank's batch (default False).
        dist_sync_fn: custom ``fn(state, reduce_fns, backend) -> state``
            replacing the built-in gather.
        process_group: the ``torch.distributed`` group to sync over (the
            default group when ``None``).
        sync_backend: an explicit :class:`~metrics_tpu_torch.parallel.Backend`
            overriding the choice from ``process_group`` (the hook
            :class:`~metrics_tpu_torch.parallel.ChaosBackend` uses).
        sync_timeout / sync_max_retries / sync_backoff: the watchdog per
            collective in seconds and the retry policy; ``None`` falls through
            to ``METRICS_TPU_SYNC_*``.  A ``torch.distributed`` collective is
            never retried (see :mod:`metrics_tpu_torch.parallel.backend`).
        on_sync_error: on a :class:`~metrics_tpu_torch.utils.exceptions.SyncError`,
            ``"raise"`` (default; env ``METRICS_TPU_ON_SYNC_ERROR``),
            ``"local"`` (compute on the local state with a warning) or
            ``"skip"`` (the same, silently).
        validate_sync: check states for NaN/Inf and dtype drift before and
            after sync, raising ``SyncIntegrityError`` (default off; env
            ``METRICS_TPU_VALIDATE_SYNC``).
        delta_sync: after a full gather, later syncs of append-only ``cat``
            states ship only the rows appended since and splice them onto the
            cached gathered prefix, when every rank votes for it in the
            preflight (default on; env kill switch ``METRICS_TPU_DELTA_SYNC=0``).

    ``compute`` returns its cached value until the next update or reset.
    Each distributed sync records ``last_sync_report`` and appends it to the
    bounded ``sync_report_history``.
    """

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = False

    # python attributes determined at runtime from the data (e.g. the
    # classification input `mode` locked on the first update) that a
    # checkpoint restore must bring back for compute() to work; values must
    # be JSON-serializable or EnumStr members
    _ckpt_attrs: Tuple[str, ...] = ()

    # set True on metrics whose per-batch appends are state-independent
    # (re-running update on a reset state appends the same rows): lets the
    # dist_sync_on_step batch gather advance the delta cache for free
    _forward_delta_advance = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self.device = _resolve_device(kwargs.pop("device", "cuda"))
        self.sync_on_compute = kwargs.pop("sync_on_compute", True)
        self.dist_sync_on_step = kwargs.pop("dist_sync_on_step", False)
        self.dist_sync_fn = kwargs.pop("dist_sync_fn", None)
        self.process_group = kwargs.pop("process_group", None)
        self.sync_backend = kwargs.pop("sync_backend", None)
        self.sync_timeout = kwargs.pop("sync_timeout", None)
        self.sync_max_retries = kwargs.pop("sync_max_retries", None)
        self.sync_backoff = kwargs.pop("sync_backoff", None)
        self.on_sync_error = kwargs.pop(
            "on_sync_error", os.environ.get("METRICS_TPU_ON_SYNC_ERROR", "").strip() or "raise"
        )
        if self.on_sync_error not in ("raise", "local", "skip"):
            raise ValueError(
                f"`on_sync_error` must be 'raise', 'local' or 'skip', got {self.on_sync_error!r}"
            )
        self.validate_sync = kwargs.pop(
            "validate_sync",
            os.environ.get("METRICS_TPU_VALIDATE_SYNC", "").strip().lower() in ("1", "true", "yes"),
        )
        self.delta_sync = kwargs.pop(
            "delta_sync",
            os.environ.get("METRICS_TPU_DELTA_SYNC", "").strip().lower() not in ("0", "false", "no"),
        )
        if kwargs:
            raise ValueError(f"Unexpected keyword arguments: {sorted(kwargs)}")
        self._defaults: Dict[str, Any] = {}
        self._reduce_fns: Dict[str, Any] = {}
        self._persistent: Dict[str, bool] = {}
        self._buffer_states: Dict[str, Dict[str, Any]] = {}
        self._update_count = 0
        self._computed: Any = None
        self._is_synced = False
        self._cache: Optional[Dict[str, Any]] = None
        self._cached_count = 0
        self._update_called_warned = False
        self._delta_cache = _DeltaCache()
        self._last_synced_state: Optional[Dict[str, Any]] = None
        self.last_sync_report: Optional[Dict[str, Any]] = None
        self.sync_report_history: deque = deque(maxlen=16)
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

    # ---------------------------------------------------------- buffer states
    def add_buffer_state(
        self,
        name: str,
        dist_reduce_fx: str = "cat",
        capacity: int = 256,
        persistent: bool = False,
    ) -> None:
        """Register a growing row buffer: a ``cat`` state held as one padded
        tensor ``<name>__buf`` (``capacity`` rows at first, doubled as it
        fills) and a Python-int row count ``<name>__len``, as the JAX package
        holds it.  ``update`` appends with :meth:`_buffer_append`; ``compute``
        reads the valid rows with :meth:`buffer_values`.
        """
        if dist_reduce_fx != "cat":
            raise ValueError("buffer states currently support only 'cat' reduction")
        self._buffer_states[name] = {
            "capacity": int(capacity),
            "alloc_cap": 0,
            "trail": None,
            "dtype": None,
            "owned": None,  # the buffer tensor this metric allocated and may write in place
        }
        # a placeholder until the first append fixes the trailing shape and dtype
        self.add_state(name + "__buf", torch.zeros((0,), dtype=torch.float32), dist_reduce_fx="cat", persistent=persistent)
        self._defaults[name + "__len"] = 0
        self._reduce_fns[name + "__len"] = "sum"
        self._persistent[name + "__len"] = persistent
        setattr(self, name + "__len", 0)

    def _buffer_keys(self) -> set:
        return {key for name in self._buffer_states for key in (name + "__buf", name + "__len")}

    def _buffer_append(self, name: str, values: torch.Tensor) -> None:
        """Append rows to buffer state ``name``, growing its capacity by doubling.

        Rows take the JAX package's dtypes (int64 as int32, float64 as
        float32); later rows promote the buffer's dtype (int rows, then float
        rows: float).  The rows are written in place only into a buffer this
        metric allocated; any other is copied first.
        """
        meta = self._buffer_states[name]
        bkey, lkey = name + "__buf", name + "__len"
        values = _x32(values)
        if values.ndim == 0:
            values = values[None]
        rows = values.shape[0]
        buf, cur = getattr(self, bkey), getattr(self, lkey)
        trail = tuple(values.shape[1:])
        if buf.ndim != values.ndim or tuple(buf.shape[1:]) != trail or buf.shape[0] == 0 or cur == 0:
            if cur:
                raise ValueError(
                    f"buffer state {name!r} holds rows of shape {tuple(buf.shape[1:])}, "
                    f"got rows of shape {trail}"
                )
            buf = torch.zeros((_grown_capacity(meta["capacity"], rows),) + trail, dtype=values.dtype, device=self.device)
        else:
            promoted = _x32_dtype(torch.promote_types(buf.dtype, values.dtype))
            if promoted != buf.dtype or cur + rows > buf.shape[0] or buf is not meta["owned"]:
                new = torch.zeros((_grown_capacity(buf.shape[0], cur + rows),) + trail, dtype=promoted, device=self.device)
                new[:cur] = buf[:cur]
                buf = new
        buf[cur : cur + rows] = values
        setattr(self, bkey, buf)
        setattr(self, lkey, cur + rows)
        meta.update(owned=buf, trail=trail, dtype=buf.dtype, alloc_cap=buf.shape[0])

    @staticmethod
    def _extract_buffer_values(buf: torch.Tensor, count: int, name: str) -> torch.Tensor:
        """The valid rows of a buffer state snapshot."""
        count = int(count)
        if count > buf.shape[0]:
            raise MetricsTPUUserError(
                f"buffer state {name!r} holds {count} rows but only capacity {buf.shape[0]}"
            )
        return buf[:count]

    def buffer_values(self, name: str) -> torch.Tensor:
        """The valid rows of buffer state ``name`` (compute-side accessor)."""
        return self._extract_buffer_values(getattr(self, name + "__buf"), getattr(self, name + "__len"), name)

    def _refresh_buffer_meta(self, name: str) -> None:
        """Re-derive a buffer's bookkeeping from the state it now holds."""
        meta = self._buffer_states[name]
        buf = getattr(self, name + "__buf")
        meta["alloc_cap"] = buf.shape[0]
        if buf.shape[0]:
            meta["trail"] = tuple(buf.shape[1:])
            meta["dtype"] = buf.dtype

    @property
    def update_count(self) -> int:
        return self._update_count

    def _copy_state(self) -> Dict[str, Any]:
        """A snapshot of the states: updates rebind tensors (buffer appends
        write past the snapshot's rows), so references suffice."""
        out: Dict[str, Any] = {}
        for name in self._defaults:
            value = getattr(self, name)
            out[name] = list(value) if isinstance(value, list) else value
        return out

    def _restore_state(self, cache: Dict[str, Any]) -> None:
        for name, value in cache.items():
            setattr(self, name, list(value) if isinstance(value, list) else value)
        for bname in self._buffer_states:
            if bname + "__buf" in cache:
                self._refresh_buffer_meta(bname)

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
        the cached global state.  With ``dist_sync_on_step`` the batch value
        is synced across processes (full path).
        """
        if self._is_synced:
            raise MetricsTPUUserError("Calling forward while the metric is synced is forbidden.")
        # custom callables and None-reduce *tensor* states have no O(1) merge
        # rule — route them through the full re-update path
        no_fast_merge = any(
            callable(fx) or (fx is None and not isinstance(getattr(self, name), list))
            for name, fx in self._reduce_fns.items()
        )
        if self.full_state_update or self.dist_sync_on_step or no_fast_merge:
            return self._forward_full_state_update(*args, **kwargs)
        return self._forward_reduce_state_update(*args, **kwargs)

    def _batch_value(self, should_sync: bool, args: tuple, kwargs: dict) -> Any:
        """Reset, update on this batch alone and compute, synced only when ``should_sync``."""
        self.reset()
        self.update(*args, **kwargs)
        prev_sync = self.sync_on_compute
        self.sync_on_compute = should_sync
        try:
            return self.compute()
        finally:
            self.sync_on_compute = prev_sync

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        self.update(*args, **kwargs)
        cache = self._copy_state()
        cached_count = self._update_count
        # the batch value syncs and resets a temporary delta cache: the batch
        # sync must vote "full", and its reset must not clear the prefix of
        # the accumulated state
        global_dc = self._delta_cache
        self._delta_cache = _DeltaCache()
        self._last_synced_state = None
        try:
            batch_val = self._batch_value(self.dist_sync_on_step, args, kwargs)
            batch_synced = self._last_synced_state
            batch_state = self._copy_state()
        finally:
            self._delta_cache = global_dc
            self._last_synced_state = None
        self._restore_state(cache)
        self._update_count = cached_count
        self._computed = None
        self._is_synced = False
        if batch_synced is not None and self._forward_delta_advance and self.delta_sync:
            self._forward_advance_delta(cache, batch_state, batch_synced)
        return batch_val

    def _forward_reduce_state_update(self, *args: Any, **kwargs: Any) -> Any:
        global_state = self._copy_state()
        global_count = self._update_count
        batch_val = self._batch_value(False, args, kwargs)
        self._reduce_states(global_state, global_count)
        self._update_count = global_count + 1
        self._computed = None
        self._is_synced = False
        return batch_val

    def _reduce_states(self, global_state: Dict[str, Any], global_count: int) -> None:
        """Merge the pre-update state with the batch state now held by the metric."""
        global_state = dict(global_state)
        for bname, meta in self._buffer_states.items():
            bkey, lkey = bname + "__buf", bname + "__len"
            g_vals = self._extract_buffer_values(global_state.pop(bkey), global_state.pop(lkey), bname)
            l_vals = self.buffer_values(bname)
            total = g_vals.shape[0] + l_vals.shape[0]
            buf = torch.zeros(
                (_grown_capacity(meta["capacity"], total),) + tuple(l_vals.shape[1:]),
                dtype=l_vals.dtype, device=self.device,
            )
            if g_vals.shape[0]:  # before the first forward the global buffer is the empty placeholder
                buf[: g_vals.shape[0]] = g_vals.to(buf.dtype)
            buf[g_vals.shape[0] : total] = l_vals
            setattr(self, bkey, buf)
            setattr(self, lkey, total)
            self._refresh_buffer_meta(bname)
            meta["owned"] = buf
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
    def _sync_options(self) -> SyncOptions:
        return SyncOptions.resolve(self.sync_timeout, self.sync_max_retries, self.sync_backoff)

    def _schema_entries(self) -> List[Tuple[str, str]]:
        """``(state_name, signature)`` pairs for the preflight digest exchange.

        A signature holds what must agree across ranks for the gather to be
        well formed: the per-row shape and dtype of cat/list states, whose
        leading dim differs with the shard, and the full shape and dtype of
        reduced states.  Shapes print as Python tuples and dtypes by their
        numpy names, so the digests equal the JAX package's for the same metric.
        """
        entries: List[Tuple[str, str]] = []
        for bname, meta in self._buffer_states.items():
            trail = meta["trail"]
            dtype = _dtype_name(meta["dtype"]) if meta["dtype"] is not None else None
            entries.append((bname, f"buffer:{trail if trail is not None else '?'}:{dtype}"))
        handled = self._buffer_keys()
        for name in self._defaults:
            if name in handled:
                continue
            value = getattr(self, name)
            fx = self._reduce_fns[name]
            if isinstance(value, list):
                if value:
                    head = value[0]
                    sig = f"list:{tuple(head.shape[1:])}:{_dtype_name(head.dtype)}"
                else:
                    # one empty and one non-empty rank would deadlock the cat
                    # gather, so emptiness is part of the signature
                    sig = "list:empty"
            elif fx == "cat" or fx is None:
                sig = f"cat:{tuple(value.shape[1:])}:{_dtype_name(value.dtype)}"
            else:
                fxn = fx if isinstance(fx, str) else getattr(fx, "__name__", "custom")
                sig = f"{fxn}:{tuple(value.shape)}:{_dtype_name(value.dtype)}"
            entries.append((name, sig))
        return entries

    def _validate_state_integrity(
        self, state: Dict[str, Any], phase: str, reference: Optional[Dict[str, Any]] = None
    ) -> None:
        """NaN/Inf and dtype-drift checks for ``validate_sync=True``."""
        for name, value in state.items():
            if isinstance(value, int):  # a buffer's row count
                continue
            leaves = value if isinstance(value, list) else [value]
            for leaf in leaves:
                if isinstance(leaf, torch.Tensor) and leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
                    raise SyncIntegrityError(
                        f"metric state {name!r} of {type(self).__name__} holds non-finite "
                        f"values {phase}; a peer contributed NaN/Inf or the payload was "
                        "corrupted in flight",
                        state=name,
                        phase=phase,
                        problem="non-finite values",
                    )
            if reference is not None and name in reference:
                ref = reference[name]
                ref_leaf = ref[0] if isinstance(ref, list) and ref else ref
                new_leaf = value[0] if isinstance(value, list) and value else value
                if isinstance(ref_leaf, torch.Tensor) and isinstance(new_leaf, torch.Tensor):
                    old_dt, new_dt = _dtype_name(ref_leaf.dtype), _dtype_name(new_leaf.dtype)
                    if old_dt != new_dt:
                        raise SyncIntegrityError(
                            f"metric state {name!r} of {type(self).__name__} drifted from "
                            f"dtype {old_dt} to {new_dt} through sync",
                            state=name,
                            phase=phase,
                            problem=f"dtype drift {old_dt} -> {new_dt}",
                        )

    def _sync_state_pure(
        self,
        state: Dict[str, Any],
        backend: Backend,
        delta_plan: Optional[Dict[str, tuple]] = None,
    ) -> Dict[str, Any]:
        """The synced states: one packed gather where the backend can, else
        one collective (or a sizes and a rows gather) per state, in state order."""
        state = dict(state)
        delta_plan = delta_plan or {}
        if getattr(backend, "supports_packed", False):
            return self._sync_state_packed(state, backend, delta_plan)
        out: Dict[str, Any] = {}
        try:
            for bname in self._buffer_states:
                bkey, lkey = bname + "__buf", bname + "__len"
                buf, cnt = state.pop(bkey), state.pop(lkey)
                with backend.annotate(bname):
                    gathered = backend.all_gather_cat(self._extract_buffer_values(buf, cnt, bname))
                out[bkey] = gathered
                out[lkey] = int(gathered.shape[0])
            for name, value in state.items():
                with backend.annotate(name):
                    if isinstance(value, list):
                        if not value:
                            out[name] = value
                            continue
                        value = torch.atleast_1d(dim_zero_cat(value))
                    elif name not in delta_plan:
                        out[name] = reduce_synced_state(value, self._reduce_fns[name], backend)
                        continue
                    if name in delta_plan:
                        value = torch.atleast_1d(value)[delta_plan[name][-1] :]
                        out[name] = self._splice_prefix(name, backend.all_gather_cat(value))
                    else:
                        out[name] = backend.all_gather_cat(value)
        except SyncTimeoutError as err:
            # per-state progress: the states that HAD completed before the straggler
            err.synced_states = sorted(k for k in out if not k.endswith("__len"))
            raise
        return out

    def _sync_state_packed(
        self, state: Dict[str, Any], backend: Backend, delta_plan: Dict[str, tuple]
    ) -> Dict[str, Any]:
        """Whole-state sync over ONE byte-blob gather.

        This rank's contribution (delta-sliced where the plan allows) goes
        into one blob and travels through ``backend.all_gather_bytes``: two
        collectives in all instead of two per state.  Each rank's part comes
        back to the metric's device, where cat states concatenate in rank
        order and reduced states fold in rank order, with their own dtypes.
        """
        payload: Dict[str, torch.Tensor] = {}
        out: Dict[str, Any] = {}
        cat_names: List[str] = []
        reduce_names: List[str] = []
        for bname in self._buffer_states:
            bkey, lkey = bname + "__buf", bname + "__len"
            payload["b." + bname] = self._extract_buffer_values(state.pop(bkey), state.pop(lkey), bname)
        for name, value in state.items():
            fx = self._reduce_fns[name]
            if isinstance(value, list) or fx == "cat" or fx is None:
                if isinstance(value, list):
                    if not value:
                        # the preflight's "list:empty" signature guarantees every
                        # rank agrees this state is empty: nothing to exchange
                        out[name] = value
                        continue
                    value = dim_zero_cat(value)
                rows = torch.atleast_1d(value)
                if name in delta_plan:
                    rows = rows[delta_plan[name][-1] :]
                payload["c." + name] = rows
                cat_names.append(name)
            else:
                payload["r." + name] = value
                reduce_names.append(name)
        try:
            with backend.annotate("packed"):
                shards = backend.all_gather_bytes(_pack_state_blob(payload))
        except SyncTimeoutError as err:
            err.synced_states = []  # all or nothing: nothing landed
            raise
        per_rank = [
            {key: t.to(self.device) for key, t in _unpack_state_blob(s).items()} for s in shards
        ]

        def cat_ranks(key: str) -> torch.Tensor:
            parts = [r[key] for r in per_rank]
            filled = [p for p in parts if p.shape[0]]
            return torch.cat(filled) if filled else parts[0]

        for bname in self._buffer_states:
            gathered = cat_ranks("b." + bname)
            out[bname + "__buf"] = gathered
            out[bname + "__len"] = int(gathered.shape[0])
        for name in cat_names:
            gathered = cat_ranks("c." + name)
            out[name] = self._splice_prefix(name, gathered) if name in delta_plan else gathered
        for name in reduce_names:
            stacked = torch.stack([r["r." + name] for r in per_rank])
            out[name] = reduce_stack(stacked, self._reduce_fns[name])
        return out

    # ------------------------------------------------------------- delta sync
    def _delta_state_names(self) -> List[str]:
        """States eligible for incremental gather: append-only cat/list rows.

        Buffer states are left out: growth and promotion rewrite their rows.
        """
        buffered = self._buffer_keys()
        return sorted(
            name
            for name, fx in self._reduce_fns.items()
            if name not in buffered and (isinstance(getattr(self, name), list) or fx == "cat" or fx is None)
        )

    def _build_delta_plan(self) -> Optional[Dict[str, tuple]]:
        """Check the cached prefixes against the current local state.

        Returns ``{name: ("list", skip_entries, watermark) | ("tensor",
        watermark)}`` when every eligible state still extends its watermark
        (rows were only appended since the last sync), else ``None``, which
        makes this rank vote for a full gather.  Purely local: the agreement
        happens in the preflight token exchange.
        """
        if not self.delta_sync:
            return None
        dc = self._delta_cache
        if dc.round < 1:
            return None
        names = self._delta_state_names()
        if not names or set(dc.watermarks) != set(names):
            return None
        plan: Dict[str, tuple] = {}
        for name in names:
            wm = int(dc.watermarks[name])
            prefix = dc.prefixes.get(name)
            if prefix is None and wm != 0:
                return None
            value = getattr(self, name)
            if isinstance(value, list):
                skip = cum = 0
                while skip < len(value) and cum < wm:
                    cum += _rows_of(value[skip])
                    skip += 1
                if cum != wm:
                    return None  # the watermark falls inside an entry: rows changed
                if prefix is not None and skip < len(value):
                    head = torch.atleast_1d(value[skip])
                    if tuple(head.shape[1:]) != tuple(prefix.shape[1:]) or head.dtype != prefix.dtype:
                        return None
                plan[name] = ("list", skip, wm)
            else:
                arr = torch.atleast_1d(value)
                if _rows_of(arr) < wm:
                    return None
                if prefix is not None and (
                    tuple(arr.shape[1:]) != tuple(prefix.shape[1:]) or arr.dtype != prefix.dtype
                ):
                    return None
                plan[name] = ("tensor", wm)
        return plan

    def _splice_prefix(self, name: str, gathered: torch.Tensor) -> torch.Tensor:
        """Prepend the cached gathered prefix to this round's gathered delta.

        Row order becomes (round, rank) blocks rather than the full gather's
        (rank, rows): a permutation identical on every rank and common to all
        of a metric's cat states, so an order-insensitive compute is unaffected.
        """
        prefix = self._delta_cache.prefixes.get(name)
        gathered = torch.atleast_1d(gathered)
        if prefix is None:
            return gathered
        if _rows_of(gathered) == 0:
            return prefix
        return torch.cat([prefix, gathered])

    def _advance_delta_cache(self, new_state: Dict[str, Any], delta_used: bool, report: Dict[str, Any]) -> None:
        """After a successful sync, install the gathered result as the next
        prefix and stamp the report with the delta telemetry."""
        dc = self._delta_cache
        saved = 0
        if delta_used:
            saved = sum(p.numel() * p.element_size() for p in dc.prefixes.values() if p is not None)
        report["delta"] = bool(delta_used)
        report["bytes_saved"] = saved
        # a full gather restarts the induction at round 1; a delta sync extends it
        dc.round = dc.round + 1 if delta_used else 1
        report["delta_round"] = dc.round
        local = self._cache or {}
        prefixes: Dict[str, Optional[torch.Tensor]] = {}
        watermarks: Dict[str, int] = {}
        for name in self._delta_state_names():
            gv = new_state.get(name, getattr(self, name))
            if isinstance(gv, list):
                if not gv:
                    prefixes[name] = None
                    watermarks[name] = 0
                    continue
                gv = dim_zero_cat(gv)
            prefixes[name] = torch.atleast_1d(gv)
            lv = local.get(name)
            if isinstance(lv, list):
                watermarks[name] = sum(_rows_of(x) for x in lv)
            else:
                watermarks[name] = _rows_of(lv) if lv is not None else 0
        dc.prefixes.clear()
        dc.prefixes.update(prefixes)
        dc.watermarks.clear()
        dc.watermarks.update(watermarks)

    def _forward_advance_delta(
        self, cache: Dict[str, Any], batch_state: Dict[str, Any], batch_synced: Dict[str, Any]
    ) -> None:
        """Advance the delta cache for free off a ``dist_sync_on_step`` batch
        gather: the batch rows every rank just exchanged are the global delta,
        so the accumulated prefix absorbs them without another collective.

        Opt-in per class (``_forward_delta_advance``): it assumes batch
        appends are state-independent.  Any inconsistency clears the cache,
        which costs one full gather.
        """
        dc = self._delta_cache
        try:
            names = self._delta_state_names()
            advanced_prefixes: Dict[str, Optional[torch.Tensor]] = {}
            advanced_wms: Dict[str, int] = {}
            for name in names:
                total, batch = cache.get(name), batch_state.get(name)
                total_rows = sum(_rows_of(x) for x in total) if isinstance(total, list) else _rows_of(total)
                batch_rows = sum(_rows_of(x) for x in batch) if isinstance(batch, list) else _rows_of(batch)
                expected_prev = total_rows - batch_rows
                if dc.round >= 1:
                    if dc.watermarks.get(name) != expected_prev:
                        dc.clear()
                        return
                elif expected_prev != 0 or dc.watermarks:
                    # no verified prefix, and the rows before this batch were
                    # never gathered: cannot start from this batch
                    dc.clear()
                    return
                gathered = batch_synced.get(name)
                if isinstance(gathered, list):
                    gathered = dim_zero_cat(gathered) if gathered else None  # None: all ranks empty
                if gathered is None:
                    advanced_prefixes[name] = dc.prefixes.get(name)
                else:
                    advanced_prefixes[name] = self._splice_prefix(name, gathered)
                advanced_wms[name] = total_rows
            if not names:
                return
            dc.prefixes.clear()
            dc.prefixes.update(advanced_prefixes)
            dc.watermarks.clear()
            dc.watermarks.update(advanced_wms)
            dc.round = max(dc.round, 0) + 1
        except Exception:
            dc.clear()

    def _finish_sync_report(self, report: Dict[str, Any], backend: Backend, start: float) -> None:
        report["duration_secs"] = round(time.perf_counter() - start, 6)
        tel = backend.pop_telemetry() or {}
        report["retries"] = int(tel.pop("retries", 0))
        report["gather_calls"] = int(tel.pop("gather_calls", 0))
        report["bytes_gathered"] = int(tel.pop("bytes_gathered", 0))
        report.update(tel)
        self.last_sync_report = report
        self.sync_report_history.append(report)

    def sync(
        self,
        dist_sync_fn: Optional[Callable] = None,
        should_sync: bool = True,
        distributed_available: Optional[bool] = None,
        backend: Optional[Backend] = None,
    ) -> None:
        """Gather and reduce the states across processes, caching the local
        state for :meth:`unsync`.

        The backend is ``backend``, else ``sync_backend``, else the one
        ``process_group`` implies (:func:`~metrics_tpu_torch.parallel.get_backend`).
        A preflight digest exchange turns a diverged peer into
        ``SyncDesyncError``; every collective runs under the watchdog of
        :meth:`_sync_options`; a ``SyncError`` is handled per
        ``on_sync_error`` (``"local"``/``"skip"`` keep the local state so
        compute stays live).  Each attempt records ``last_sync_report``.
        """
        if self._is_synced:
            raise MetricsTPUUserError("The Metric has already been synced.")
        self._last_synced_state = None
        saved_options: Any = _UNSET
        if backend is None:
            backend = self.sync_backend
        if backend is None:
            backend = get_backend(self.process_group, self._sync_options())
        elif hasattr(backend, "options") and (
            self.sync_timeout is not None or self.sync_max_retries is not None or self.sync_backoff is not None
        ):
            # per-metric knobs take precedence for THIS call only: an injected
            # backend may be shared across metrics
            saved_options = backend.options
            backend.options = self._sync_options()
        try:
            if distributed_available is None:
                distributed_available = backend.is_distributed()
            self._cache = self._copy_state()
            self._cached_count = self._update_count
            if not should_sync or not distributed_available:
                self._is_synced = True
                return
            report: Dict[str, Any] = {
                "backend": type(backend).__name__,
                "world_size": int(backend.world_size()),
                "fallback": None,
                "error": None,
            }
            start = time.perf_counter()
            delta_plan = None
            delta_ok = False
            custom_fn = dist_sync_fn or self.dist_sync_fn
            backend_delta = getattr(backend, "supports_delta", False) and custom_fn is None
            try:
                if self.validate_sync:
                    self._validate_state_integrity(self._copy_state(), "pre-sync")
                preflight_kwargs: Dict[str, Any] = {}
                if backend_delta:
                    delta_plan = self._build_delta_plan()
                    preflight_kwargs["delta_token"] = (
                        self._delta_cache.token(list(delta_plan)) if delta_plan else None
                    )
                info = backend.preflight_check(self._schema_entries(), self._update_count, **preflight_kwargs)
                if info:
                    report.update(info)
                # delta only when EVERY rank voted a matching token
                delta_ok = bool(delta_plan) and bool((info or {}).get("delta_ok"))
                if custom_fn is not None:
                    new_state = custom_fn(self._copy_state(), dict(self._reduce_fns), backend)
                else:
                    new_state = self._sync_state_pure(self._copy_state(), backend, delta_plan if delta_ok else None)
                if self.validate_sync:
                    self._validate_state_integrity(new_state, "post-sync", reference=self._cache)
                self._restore_state(new_state)
                self._is_synced = True
                self._last_synced_state = new_state
                if backend_delta and self.delta_sync:
                    self._advance_delta_cache(new_state, delta_ok, report)
            except SyncError as err:
                # the ranks no longer provably share one prefix: re-verify
                # from a full gather next time
                self._delta_cache.clear()
                report["error"] = f"{type(err).__name__}: {err}"
                if self.on_sync_error == "raise":
                    self._finish_sync_report(report, backend, start)
                    raise
                report["fallback"] = "local"
                if self.on_sync_error == "local":
                    rank_zero_warn(
                        f"Metric {type(self).__name__} sync failed ({type(err).__name__}: {err}); "
                        "falling back to local unsynced state on this rank.",
                        UserWarning,
                    )
                self._restore_state(self._cache)
                self._is_synced = True
            except BaseException:
                self._delta_cache.clear()
                raise
            self._finish_sync_report(report, backend, start)
        finally:
            if saved_options is not _UNSET:
                backend.options = saved_options

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
    def sync_context(
        self,
        dist_sync_fn: Optional[Callable] = None,
        should_sync: bool = True,
        should_unsync: bool = True,
        distributed_available: Optional[bool] = None,
        backend: Optional[Backend] = None,
    ) -> Iterator["Metric"]:
        """Synced within the block, local again after it."""
        self.sync(
            dist_sync_fn=dist_sync_fn,
            should_sync=should_sync,
            distributed_available=distributed_available,
            backend=backend,
        )
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
        self._delta_cache.clear()  # gathered prefixes describe the cleared epoch
        self._last_synced_state = None
        for name, default in self._defaults.items():
            if isinstance(default, list):
                setattr(self, name, [])
            elif isinstance(default, int):
                setattr(self, name, default)  # a buffer's row count
            else:
                setattr(self, name, default.clone())
        for bname, meta in self._buffer_states.items():
            meta["owned"] = None
            if meta["trail"] is not None:
                # keep the grown capacity, trailing shape and dtype across resets
                cap = max(meta["alloc_cap"], meta["capacity"], 1)
                buf = torch.zeros((cap,) + meta["trail"], dtype=meta["dtype"], device=self.device)
                setattr(self, bname + "__buf", buf)
                meta["owned"] = buf

    def clone(self) -> "Metric":
        return copy.deepcopy(self)

    # ------------------------------------------------------------ persistence
    def persistent(self, mode: bool = False) -> None:
        for name in self._persistent:
            self._persistent[name] = mode

    def _save_to_state_dict(self, destination: Dict[str, Any], prefix: str, keep_vars: bool) -> None:
        """Add the persistent states to ``state_dict()``."""
        super()._save_to_state_dict(destination, prefix, keep_vars)
        trimmed = self._trimmed_buffers()
        for name in self._defaults:
            if not self._persistent[name]:
                continue
            value = trimmed.get(name, getattr(self, name))
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
        self._load_states({name: state_dict.pop(prefix + name) for name in self._defaults if prefix + name in state_dict})
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

    def _trimmed_buffers(self) -> Dict[str, Any]:
        """Each buffer state as its valid rows and an int32 row count, as checkpoints hold it."""
        out: Dict[str, Any] = {}
        for bname in self._buffer_states:
            rows = self.buffer_values(bname)
            out[bname + "__buf"] = rows
            out[bname + "__len"] = torch.tensor(rows.shape[0], dtype=torch.int32, device=self.device)
        return out

    def state_pytree(self) -> Dict[str, Any]:
        """The full state as a flat dict: ``_update_count`` and every state,
        list states concatenated, buffer states trimmed to their valid rows."""
        out: Dict[str, Any] = {"_update_count": self._update_count}
        for name in self._defaults:
            value = getattr(self, name)
            out[name] = dim_zero_cat(value) if isinstance(value, list) and value else value
        out.update(self._trimmed_buffers())
        return out

    def _load_states(self, states: Dict[str, Any]) -> None:
        """Install loaded states (tensors, numpy arrays or numbers) on this metric's device."""
        counts = {name + "__len" for name in self._buffer_states}
        for name, value in states.items():
            if name not in self._defaults:
                raise KeyError(f"unknown state {name!r}")
            if name in counts:
                setattr(self, name, int(value))
            elif isinstance(value, list):
                setattr(self, name, [_to_state_tensor(v, self.device) for v in value])
            elif isinstance(self._defaults[name], list):
                setattr(self, name, [_to_state_tensor(value, self.device)])
            else:
                setattr(self, name, _to_state_tensor(value, self.device))
        for bname in self._buffer_states:
            if bname + "__buf" in states:
                self._refresh_buffer_meta(bname)

    def load_state_pytree(self, tree: Dict[str, Any]) -> None:
        """Load what :meth:`state_pytree` returns (tensors or numpy arrays) onto this metric's device."""
        tree = dict(tree)
        self._delta_cache.clear()  # loaded rows were never part of a gathered prefix
        self._computed = None  # a cached compute() predates the loaded state
        self._update_count = int(tree.pop("_update_count", 0))
        self._load_states(tree)

    # -------------------------------------------------------------- pickling
    def __getstate__(self) -> Dict[str, Any]:
        d = self.__dict__.copy()
        # bound-method wrappers are reinstalled in __setstate__
        for key in ("update", "compute", "_update_impl", "_compute_impl"):
            d.pop(key, None)
        d["_cache"] = None
        d["_computed"] = None
        # a restored metric re-verifies from one full gather
        d["_delta_cache"] = None
        d["_last_synced_state"] = None
        return d

    def __setstate__(self, d: Dict[str, Any]) -> None:
        super().__setstate__(d)
        self._delta_cache = _DeltaCache()
        self._install_wrappers()

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """Keep only the kwargs the update signature accepts."""
        params = inspect.signature(self._update_impl).parameters
        if any(p.kind == p.VAR_KEYWORD for p in params.values()):
            return kwargs
        return {k: v for k, v in kwargs.items() if k in params}
