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
:meth:`Metric.sync_async` runs such a round on a background thread instead,
and the next ``sync`` folds it in (the catch-up barrier).

Host-orchestrated metrics (the string metrics) sum their per-update
statistics on the host (:meth:`Metric._host_accumulate`, numpy float64) and
fold them into their states at the next read.  While sums are pending, the
states are held out of the instance's ``__dict__``, so that a direct read of
one (``m.errors``) passes through ``__getattr__`` and flushes first, as every
other read surface does (``state``, ``forward``, ``compute``, ``sync``,
``merge_state``, ``state_dict``, pickling).

:meth:`Metric.shard` places the states on a
:class:`~torch.distributed.device_mesh.DeviceMesh`: they stay each rank's
plain tensors, sync through the mesh's own collectives
(:class:`~metrics_tpu_torch.parallel.mesh.MeshBackend`), and :attr:`Metric.state`
shows them as the :class:`~torch.distributed.tensor.DTensor` leaves the
placement describes.  See :mod:`metrics_tpu_torch.parallel.mesh`.

Metrics compose with Python's operators (``(f1 + acc) / 2``, ``-prec``,
``acc[7]``): each builds a :class:`CompositionalMetric` that updates its
operands and applies the operator to their computed values.
"""

import copy
import hashlib
import inspect
import numbers
import os
import struct
import time
import warnings
from abc import ABC, abstractmethod
from collections import OrderedDict, deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn.modules.module import _IncompatibleKeys

from metrics_tpu_torch.obs import core as _obs
from metrics_tpu_torch.parallel.backend import (
    AsyncSyncHandle,
    AxisBackend,
    Backend,
    SyncOptions,
    _dtensor_type,
    get_backend,
    local_value,
    reduce_stack,
    reduce_synced_state,
    submit_async_round,
)
from metrics_tpu_torch.utils.data import _squeeze_if_scalar, _x32, _x32_dtype, dim_zero_cat
from metrics_tpu_torch.utils.exceptions import (
    MetricsTPUUserError,
    SyncError,
    SyncIntegrityError,
    SyncTimeoutError,
)
from metrics_tpu_torch.utils.prints import rank_zero_warn


def jit_distributed_available() -> bool:
    """Whether ``compute`` has peers to sync with: a ``torch.distributed`` process group is
    initialised with more than one rank (the JAX package's ``jax.process_count() > 1``)."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _metric_labels(metric: "Metric") -> Dict[str, Any]:
    return {"metric": type(metric).__name__}


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

    ``inflight`` holds the one background round :meth:`Metric.sync_async`
    has parked (``None`` when there is none); ``generation`` grows with every
    :meth:`clear`, so a round submitted before a clear is stale and is
    dropped, not folded.
    """

    def __init__(self) -> None:
        self.prefixes: Dict[str, Optional[torch.Tensor]] = {}
        self.watermarks: Dict[str, int] = {}
        # each tensor state's local value as the last sync saw it: rows under the
        # watermark that an update rewrote (not appended to) void the prefix
        self.locals: Dict[str, Any] = {}
        self.round = 0
        self.inflight: Optional[Dict[str, Any]] = None
        self.generation = 0

    def clear(self) -> None:
        self.prefixes.clear()
        self.watermarks.clear()
        self.locals.clear()
        self.round = 0
        self.inflight = None
        self.generation += 1

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


def _flatten_batched_inputs(args: tuple, kwargs: dict) -> Tuple[list, Callable[[Sequence[Any]], Tuple[tuple, dict]], List[bool], Optional[int], bool]:
    """Flatten an update's ``(args, kwargs)`` and classify its leaves for stacked rows.

    Tensor and array leaves with ``ndim >= 1`` carry the leading row axis;
    every other leaf passes through unchanged.  Returns ``(leaves, rebuild,
    is_batched, n, ragged)``: ``rebuild(leaves)`` gives ``(args, kwargs)``
    back, ``n`` is the leading size of the first batched leaf (``None``
    without one) and ``ragged`` flags batched leaves of another leading size.
    The JAX package flattens nested pytrees; an update here takes its arrays
    at the top level.
    """
    keys = list(kwargs)
    leaves = list(args) + [kwargs[k] for k in keys]
    is_batched = [isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim >= 1 for x in leaves]
    batched = [x for x, b in zip(leaves, is_batched) if b]
    n = int(batched[0].shape[0]) if batched else None
    ragged = any(int(x.shape[0]) != n for x in batched)

    def rebuild(new_leaves: Sequence[Any]) -> Tuple[tuple, dict]:
        new_leaves = list(new_leaves)
        return tuple(new_leaves[: len(args)]), dict(zip(keys, new_leaves[len(args) :]))

    return leaves, rebuild, is_batched, n, ragged


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


def _rows_unchanged(value: torch.Tensor, seen: Any, rows: int) -> bool:
    """Whether the first ``rows`` rows of tensor state ``value`` are those of ``seen``,
    its value at the last sync (one device read unless it is the same tensor)."""
    if value is seen:
        return True
    if not isinstance(seen, torch.Tensor):
        return False
    now, then = torch.atleast_1d(value)[:rows], torch.atleast_1d(seen)[:rows]
    return now.shape == then.shape and now.dtype == then.dtype and bool(torch.equal(now, then))


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


class _Uint32Words:
    """A ``torch.uint32`` tensor (a sketch's PRNG key) inside a pickle.

    PyTorch pickles that dtype's storage but cannot load it back, so it
    travels as the int32 words of the same bits.
    """

    def __init__(self, tensor: torch.Tensor) -> None:
        self.words = tensor.view(torch.int32)

    def tensor(self) -> torch.Tensor:
        return self.words.view(torch.uint32)


def _picklable(value: Any) -> Any:
    """``value`` (or a dict's values) with every ``torch.uint32`` tensor as :class:`_Uint32Words`."""
    if isinstance(value, torch.Tensor) and value.dtype == torch.uint32:
        return _Uint32Words(value)
    if type(value) is dict:
        return {k: _picklable(v) for k, v in value.items()}
    return value


def _unpickled(value: Any) -> Any:
    """The inverse of :func:`_picklable`."""
    if isinstance(value, _Uint32Words):
        return value.tensor()
    if type(value) is dict:
        return {k: _unpickled(v) for k, v in value.items()}
    return value


#: how a reduced state's contributions combine, by DTensor's ``Partial`` names
_PARTIAL_OPS = {"sum": "sum", "mean": "avg", "max": "max", "min": "min"}


def _local_batch(args: tuple, kwargs: dict) -> Tuple[tuple, dict]:
    """An update's DTensor inputs as their local shards.

    A DTensor batch must be split along its rows (``Shard(0)``): each rank
    counts its own shard.  A replicated batch would be counted once per rank,
    and a partial one has no rows of its own: both raise.
    """
    cls = _dtensor_type()
    if cls is None:
        return args, kwargs

    def local(x: Any) -> Any:
        if not isinstance(x, cls):
            return x
        if not any(p.is_shard(0) for p in x.placements) or any(p.is_partial() for p in x.placements):
            raise MetricsTPUUserError(
                f"a DTensor batch must be split along its rows (Shard(0)) over the mesh axis, got "
                f"placements {tuple(x.placements)}: a replicated batch would be counted once per rank"
            )
        return x.to_local()

    return tuple(local(a) for a in args), {k: local(v) for k, v in kwargs.items()}


def _chunk_rows(rows: torch.Tensor, world: int, me: int) -> torch.Tensor:
    """Rank ``me``'s piece of ``rows`` as ``torch.chunk`` splits them over ``world`` ranks
    (the layout a DTensor ``Shard(0)`` assumes); past the last chunk, no rows."""
    pieces = torch.chunk(rows, world) if rows.shape[0] else ()
    return pieces[me].clone() if me < len(pieces) else rows[:0].clone()


#: the side stream each device's background sync rounds run on
_WORKER_STREAMS: Dict[torch.device, Any] = {}


def _side_stream(device: torch.device) -> Optional[Any]:
    """The side stream of ``device`` that background sync rounds run on (None
    off the card), made on the caller's thread.  The first stream of a process
    also makes PyTorch's stream pools, which takes tens of milliseconds, so a
    metric that may run async rounds makes it when it takes a CUDA device
    rather than at its first :meth:`Metric.sync_async`."""
    if device.type != "cuda":
        return None
    stream = _WORKER_STREAMS.get(device)
    if stream is None:
        stream = _WORKER_STREAMS[device] = torch.cuda.Stream(device)
    return stream


@contextmanager
def _on_side_stream(stream: Optional[Any], ready: Any) -> Iterator[None]:
    """Run a background sync round's device work on ``stream`` after it waits
    for ``ready`` (recorded after the snapshot on the caller's stream), and
    wait for the stream before leaving.

    PyTorch's side streams do not synchronize with the legacy default stream,
    so the round neither reads the snapshot before it is written nor queues
    behind the kernels the caller launches after it.
    """
    if stream is None:
        yield
        return
    with torch.cuda.device(stream.device), torch.cuda.stream(stream):
        stream.wait_event(ready)
        try:
            yield
        finally:
            stream.synchronize()


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
        axis_name: a mesh axis to sync over as one SPMD program
            (:class:`~metrics_tpu_torch.parallel.AxisBackend` over the default
            group); the ambient :class:`~metrics_tpu_torch.parallel.axis_context`
            does the same.
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
        async_sync: ``None`` (default) lets :meth:`sync_async` run rounds on
            the background worker; ``True`` also overlaps the per-step sync
            of ``dist_sync_on_step`` (the step's value is then the local
            batch value); ``False`` turns :meth:`sync_async` into a no-op, as
            does ``METRICS_TPU_ASYNC_SYNC=0``.
        compute_on_cpu: move list and buffer states to host memory after
            every update, so the rows never pile up on the device; their
            compute runs on the CPU (default False).
        compute_with_cache: return the cached ``compute`` value until the
            next update (default True); ``False`` recomputes on every call.

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

    # False where an update needs concrete values on the host (the JAX package's
    # ``jit_update=False``): the JAX package's BootStrapper then draws its
    # resamples per copy, and the port's draws as it does
    traced_update = True

    # whether a MultiStreamMetric may stack this metric's states per stream:
    # False for growing list/buffer states, None where the JAX package leaves
    # it unsaid (stacked_states decides)
    stackable: Optional[bool] = None

    # set on a MultiStreamMetric's base, whose update then runs once per row
    # under torch.func.vmap, where no value can be read on the host: as under a
    # JAX trace, value checks that read the host are skipped
    _rows_mapped = False

    # True where the list states stay in host memory whatever ``device`` is
    # (MeanAveragePrecision: its compute runs on the host, so device-resident
    # entries would cost one device->host copy each); loads, merges and syncs
    # then keep them there
    _host_list_states = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self.device = _resolve_device(kwargs.pop("device", "cuda"))
        self.sync_on_compute = kwargs.pop("sync_on_compute", True)
        self.dist_sync_on_step = kwargs.pop("dist_sync_on_step", False)
        self.dist_sync_fn = kwargs.pop("dist_sync_fn", None)
        self.process_group = kwargs.pop("process_group", None)
        self.axis_name = kwargs.pop("axis_name", None)
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
        self.async_sync = kwargs.pop("async_sync", None)
        if os.environ.get("METRICS_TPU_ASYNC_SYNC", "").strip().lower() in ("0", "false", "no"):
            self.async_sync = False
        if self.async_sync is not False:
            _side_stream(self.device)
        self.compute_on_cpu = kwargs.pop("compute_on_cpu", False)
        self.compute_with_cache = kwargs.pop("compute_with_cache", True)
        if kwargs:
            raise ValueError(f"Unexpected keyword arguments: {sorted(kwargs)}")
        self._defaults: Dict[str, Any] = {}
        self._widen_ndim: Dict[str, Optional[int]] = {}
        self._reduce_fns: Dict[str, Any] = {}
        self._persistent: Dict[str, bool] = {}
        self._buffer_states: Dict[str, Dict[str, Any]] = {}
        # fixed-shape mergeable sketch states: name -> {"merge": fn([tree, ...]) -> tree, "leaves": [leaf, ...]}
        self._sketch_states: Dict[str, Dict[str, Any]] = {}
        # per-state PartitionSpec overrides (add_state(spec=...)) and, once
        # shard() ran, (mesh, axis_name)
        self._specs: Dict[str, Any] = {}
        self._placement: Optional[Tuple[Any, str]] = None
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
        self._host_buffers_dirty = False
        self._state_swapped = False
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
        widen_ndim: Optional[int] = 0,
        spec: Optional[Any] = None,
    ) -> None:
        """Register a streaming state.

        ``default`` is a tensor, numpy array or number (tensor state, fixed
        shape) or an empty Python list (list state, gathered with ``cat``
        semantics).

        ``widen_ndim`` declares a scalar state that an update may widen to one
        entry per class or output, its shape set by the data (a one-vs-all
        hinge loss, a multi-output explained variance): the most dimensions it
        may take, ``None`` for any.  Such a state loads (:func:`load_jax_state`)
        as a scalar or with any shape of that many dimensions or fewer; every
        other tensor state keeps its default's shape.

        ``spec`` is an optional
        :class:`~metrics_tpu_torch.parallel.mesh.PartitionSpec` read by
        :meth:`shard`: where this state lives on the device mesh.  Reduced
        states (``sum``/``mean``/``max``/``min``) hold a complete value after
        every sync, so a sharded spec on one is a contract error; row states
        (``cat``/list/buffer rows) default to row sharding (``P('batch')``).
        """
        if isinstance(dist_reduce_fx, str):
            if dist_reduce_fx not in _ALLOWED_REDUCE:
                raise ValueError(f"`dist_reduce_fx` must be one of {_ALLOWED_REDUCE}, callable or None")
        elif dist_reduce_fx is not None and not callable(dist_reduce_fx):
            raise ValueError("`dist_reduce_fx` must be a str, callable or None")
        if spec is not None:
            from metrics_tpu_torch.parallel.mesh import PartitionSpec

            if not isinstance(spec, PartitionSpec):
                raise ValueError(
                    f"`spec` must be a metrics_tpu_torch.parallel.PartitionSpec, got {type(spec).__name__}"
                )
            if any(ax is not None for ax in spec) and dist_reduce_fx in ("sum", "mean", "max", "min"):
                raise ValueError(
                    f"state {name!r}: a sharded spec={spec} contradicts dist_reduce_fx={dist_reduce_fx!r} — "
                    "reduced states hold the full value on every rank after a sync and must replicate (P())"
                )
        if isinstance(default, list):
            if default:
                raise ValueError("list states must default to the empty list")
        elif isinstance(default, (torch.Tensor, np.ndarray, numbers.Number)):
            default = _to_state_tensor(default, self.device)
        else:
            raise ValueError("state default must be a tensor, an array, a number, or an empty list")
        if not name.isidentifier():
            raise ValueError(f"state name must be a valid identifier, got {name!r}")
        if widen_ndim != 0 and (isinstance(default, list) or default.ndim != 0):
            raise ValueError(f"state {name!r}: only a scalar tensor state may widen")
        self._defaults[name] = default
        self._reduce_fns[name] = dist_reduce_fx
        self._persistent[name] = persistent
        self._widen_ndim[name] = widen_ndim
        self._specs[name] = spec
        setattr(self, name, [] if isinstance(default, list) else default.clone())

    def _holds_shape(self, name: str, shape: Tuple[int, ...]) -> bool:
        """Whether tensor state ``name`` may hold a value of ``shape``: its
        default's shape, or, for a state declared with ``widen_ndim``, any
        shape of at most that many dimensions."""
        shape = tuple(shape)
        if shape == tuple(self._defaults[name].shape):
            return True
        widen = self._widen_ndim.get(name, 0)
        return widen is None or len(shape) <= widen

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
        where = self._buffer_device()
        values = _x32(values).to(where)
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
            buf = torch.zeros((_grown_capacity(meta["capacity"], rows),) + trail, dtype=values.dtype, device=where)
        else:
            promoted = _x32_dtype(torch.promote_types(buf.dtype, values.dtype))
            if promoted != buf.dtype or cur + rows > buf.shape[0] or buf is not meta["owned"]:
                new = torch.zeros((_grown_capacity(buf.shape[0], cur + rows),) + trail, dtype=promoted, device=where)
                new[:cur] = buf[:cur]
                buf = new
        buf[cur : cur + rows] = values
        setattr(self, bkey, buf)
        setattr(self, lkey, cur + rows)
        meta.update(owned=buf, trail=trail, dtype=buf.dtype, alloc_cap=buf.shape[0])

    def _buffer_device(self) -> torch.device:
        """Where buffer rows accumulate: host memory with ``compute_on_cpu``, else the metric's device."""
        return torch.device("cpu") if self.compute_on_cpu else self.device

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

    # ---------------------------------------------------------- sketch states
    def add_sketch_state(self, name: str, default: Dict[str, Any], merge_fn: Callable, persistent: bool = False) -> None:
        """Register a fixed-shape mergeable sketch state (:mod:`metrics_tpu_torch.streaming`).

        ``default`` is a flat dict of fixed-shape tensors (a sketch's state,
        e.g. :func:`metrics_tpu_torch.streaming.kll_init`); ``merge_fn`` folds
        a sequence of such dicts into one (e.g. ``kll_merge``).  Each leaf
        becomes a tensor state ``<name>__sk_<leaf>`` whose ``dist_reduce_fx``
        is ``"sketch"``: a sync gathers every rank's leaves and folds the
        per-rank trees through ``merge_fn`` in rank order, and
        :meth:`merge_state` does the same.  A sketch is fixed-size, so it is
        never delta-synced, and its leaves may hold ``±inf`` padding, which
        the ``validate_sync`` checks let through.
        """
        if not isinstance(default, dict) or not default:
            raise ValueError("sketch state default must be a non-empty dict of arrays")
        if not callable(merge_fn):
            raise ValueError("sketch merge_fn must be callable")
        if not name.isidentifier():
            raise ValueError(f"state name must be a valid identifier, got {name!r}")
        if name in self._sketch_states:
            raise ValueError(f"sketch state {name!r} already registered")
        leaves = sorted(default)
        for leaf in leaves:
            if not leaf.isidentifier():
                raise ValueError(f"sketch leaf name must be a valid identifier, got {leaf!r}")
            key = f"{name}__sk_{leaf}"
            self.add_state(key, default[leaf], dist_reduce_fx=None, persistent=persistent)
            # "sketch" is not a reduce add_state takes: it needs the merge_fn registered below
            self._reduce_fns[key] = "sketch"
        self._sketch_states[name] = {"merge": merge_fn, "leaves": leaves}

    def _sketch_leaf_keys(self, name: str) -> List[str]:
        return [f"{name}__sk_{leaf}" for leaf in self._sketch_states[name]["leaves"]]

    def sketch_tree(self, name: str, state: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """The sketch's state dict (leaf name -> tensor), from ``state`` or the live metric state."""
        return {
            leaf: getattr(self, f"{name}__sk_{leaf}") if state is None else state[f"{name}__sk_{leaf}"]
            for leaf in self._sketch_states[name]["leaves"]
        }

    def _store_sketch_tree(self, name: str, tree: Dict[str, Any], state: Optional[Dict[str, Any]] = None) -> None:
        """Write a sketch's state dict back into ``state`` (or the live state)."""
        for leaf in self._sketch_states[name]["leaves"]:
            if state is None:
                setattr(self, f"{name}__sk_{leaf}", tree[leaf])
            else:
                state[f"{name}__sk_{leaf}"] = tree[leaf]

    def _sketch_leaf_key_set(self) -> set:
        return {k for name in self._sketch_states for k in self._sketch_leaf_keys(name)}

    def _merge_sketches(self, name: str, states: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        """Fold sketch ``name`` of each state dict (in order) through its ``merge_fn``."""
        trees = [self.sketch_tree(name, state) for state in states]
        return self._sketch_states[name]["merge"](trees) if len(trees) > 1 else trees[0]

    def state_kinds(self) -> Dict[str, str]:
        """Each logical state's kind: ``"tensor"``, ``"list"``, ``"buffer"`` (one entry for
        ``<name>__buf`` and ``<name>__len``) or ``"sketch"`` (one entry for every
        ``<name>__sk_<leaf>``), as the JAX package's checkpoint codec reads them."""
        out: Dict[str, str] = {}
        covered: set = set()
        for name in self._sketch_states:
            out[name] = "sketch"
            covered.update(self._sketch_leaf_keys(name))
        for name in self._buffer_states:
            out[name] = "buffer"
            covered.update((name + "__buf", name + "__len"))
        for name, default in self._defaults.items():
            if name not in covered:
                out[name] = "list" if isinstance(default, list) else "tensor"
        return out

    def state_keys(self, name: str) -> List[str]:
        """The flat :meth:`state_pytree` keys that make up logical state ``name``."""
        if name in self._sketch_states:
            return self._sketch_leaf_keys(name)
        if name in self._buffer_states:
            return [name + "__buf", name + "__len"]
        if name in self._defaults:
            return [name]
        raise KeyError(f"unknown state {name!r}")

    def stacked_states(self, num_streams: int) -> List[Dict[str, Any]]:
        """Registration specs for this metric's states with a leading
        ``(num_streams, ...)`` stream axis (:class:`~metrics_tpu_torch.multistream.MultiStreamMetric`'s
        registration hook).

        One spec per *logical* state: ``{"kind": "tensor", "name", "default",
        "reduce"}`` for tensor states and ``{"kind": "sketch", "name", "tree",
        "merge"}`` for sketch states, each default or leaf repeated to
        ``(num_streams,) + shape``.  A PRNG-key leaf (``torch.uint32``
        ``(2,)``, a KLL sketch's compaction key) is not repeated but folded per
        stream, ``jax.random.fold_in(key, stream)`` bit for bit, so the
        streams' coin flips decorrelate.  List and buffer states grow with the
        stream and have no stacked form: they raise.
        """
        from metrics_tpu_torch.streaming import _threefry

        num_streams = int(num_streams)
        if num_streams < 1:
            raise ValueError(f"num_streams must be >= 1, got {num_streams}")
        streams = torch.arange(num_streams, dtype=torch.int64, device=self.device)

        def _stack(leaf: torch.Tensor) -> torch.Tensor:
            if leaf.dtype == torch.uint32 and tuple(leaf.shape) == (2,):
                return _threefry.as_uint32(_threefry.fold_in(leaf, streams))
            return leaf.expand((num_streams,) + tuple(leaf.shape)).clone()

        specs: List[Dict[str, Any]] = []
        covered = self._sketch_leaf_key_set()
        for name, meta in self._sketch_states.items():
            tree = {leaf: _stack(self._defaults[f"{name}__sk_{leaf}"]) for leaf in meta["leaves"]}
            specs.append({"kind": "sketch", "name": name, "tree": tree, "merge": meta["merge"]})
        buffer_keys = self._buffer_keys()
        for name, default in self._defaults.items():
            if name in covered:
                continue
            if isinstance(default, list) or name in buffer_keys:
                raise MetricsTPUUserError(
                    f"state {name!r} is a list/buffer state; growing states have no "
                    "fixed-shape per-stream stacked form"
                )
            specs.append({"kind": "tensor", "name": name, "default": _stack(default), "reduce": self._reduce_fns[name]})
        return specs

    @property
    def _list_device(self) -> torch.device:
        """Where list-state entries live: host memory with ``_host_list_states``, else the metric's device."""
        return torch.device("cpu") if self._host_list_states else self.device

    @property
    def update_count(self) -> int:
        return self._update_count

    @property
    def state(self) -> Dict[str, Any]:
        """The raw states, ``{name: value}``: tensors, lists of tensors and the
        Python-int row counts of buffer states (a fresh dict of the live values;
        a placed metric's leaves as DTensors where a placement describes them,
        :meth:`_placed_view`)."""
        self._flush_host_buffers()
        if self._placement is None:
            return {name: getattr(self, name) for name in self._defaults}
        return {name: self._placed_view(name, getattr(self, name)) for name in self._defaults}

    # ------------------------------------------------------- host-side buffers
    def _host_accumulate(self, **increments: Any) -> None:
        """Sum per-update host statistics (Python or numpy numbers) into the named
        states at the next read instead of now: the sums wait on the host in
        float64, and the states take one add each when read.

        Under the pure state API (:meth:`apply_update`) the increments land in
        the swapped-in state at once.
        """
        if self._state_swapped:
            for name, inc in increments.items():
                self._fold_host_sum(name, np.asarray(inc, np.float64))
            return
        acc = self.__dict__.setdefault("_host_scalar_acc", {})
        for name, inc in increments.items():
            inc = np.asarray(inc, np.float64)
            prev = acc.get(name)
            acc[name] = inc if prev is None else prev + inc
        self._hold_states()

    def _append_list_state(self, name: str, value: torch.Tensor) -> None:
        """Append to a list state without folding the pending host sums (a held
        list takes the entry where it waits)."""
        held = self.__dict__.get("_held_states")
        (held[name] if held and name in held else getattr(self, name)).append(value)

    def _fold_host_sum(self, name: str, inc: np.ndarray) -> None:
        # cast to the state's dtype first, then add: float32 states match the
        # JAX package's `state + jnp.asarray(inc, state.dtype)` bit for bit
        state = getattr(self, name)
        setattr(self, name, state + torch.as_tensor(inc, dtype=state.dtype).to(state.device))

    def _hold_states(self) -> None:
        """Mark host-side buffers pending: every state leaves ``__dict__``, so a
        read of any of them reaches ``__getattr__``, which flushes first."""
        self._host_buffers_dirty = True
        held = self.__dict__.setdefault("_held_states", {})
        live = self.__dict__
        for name in self._defaults:
            if name in live:
                held[name] = live.pop(name)

    def _release_states(self) -> None:
        """Put the held states back into ``__dict__`` as they are (no flush)."""
        held = self.__dict__.get("_held_states")
        if held:
            self.__dict__.update(held)
            held.clear()

    def __getattr__(self, name: str) -> Any:
        held = self.__dict__.get("_held_states")
        if held and name in held:
            self._flush_host_buffers()
            # a flush already running (an image queue's drain) leaves it held
            return held[name] if name in held else self.__dict__[name]
        return super().__getattr__(name)

    def __setattr__(self, name: str, value: Any) -> None:
        held = self.__dict__.get("_held_states")
        if held and name in held:
            held[name] = value
            return
        super().__setattr__(name, value)

    def _follow_leader(self, leader: "Metric") -> None:
        """A compute-group member whose leader has pending host buffers takes the
        leader's states at its own next read, not at every collection update."""
        self.__dict__["_leader_pending"] = leader
        self._hold_states()

    def _flush_host_buffers(self) -> None:
        """Fold the host-side buffers into the states.  Runs at every read
        surface (``state``, ``forward``, ``compute``, ``sync``, ``merge_state``,
        pickling, and a direct read of a held state), never at update entry, so
        sums accumulate across updates.  The base folds the
        :meth:`_host_accumulate` sums; subclasses with buffers of their own
        (an image queue, a sketch's compaction count) extend it.  A swapped-in
        state never absorbs the instance's pending sums."""
        if self._state_swapped or not self._host_buffers_dirty:
            return
        self._release_states()
        leader = self.__dict__.pop("_leader_pending", None)
        if leader is not None:
            for key in self._defaults:
                value = getattr(leader, key)
                setattr(self, key, list(value) if isinstance(value, list) else value)
            for bname, meta in self._buffer_states.items():
                self._refresh_buffer_meta(bname)
                meta["owned"] = None
        acc = self.__dict__.get("_host_scalar_acc")
        if acc:
            self.__dict__["_host_scalar_acc"] = {}
            for name, inc in acc.items():
                self._fold_host_sum(name, inc)
        self._host_buffers_dirty = False

    def _stash_host_buffers(self) -> Tuple[Dict[str, Any], Any, bool]:
        """Set the pending host buffers aside (the states stay as they are) for a swapped-in state."""
        pending = (self.__dict__.pop("_host_scalar_acc", {}), self.__dict__.pop("_leader_pending", None),
                   self._host_buffers_dirty)
        self._release_states()
        self._host_buffers_dirty = False
        return pending

    def _unstash_host_buffers(self, pending: Tuple[Dict[str, Any], Any, bool]) -> None:
        acc, leader, dirty = pending
        self.__dict__["_host_scalar_acc"] = acc
        if leader is not None:
            self.__dict__["_leader_pending"] = leader
        if dirty:
            self._hold_states()

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

    # ----------------------------------------------------------- pure state API
    def init_state(self) -> Dict[str, Any]:
        """A fresh state dict of the defaults; buffer-state row counts stay Python ints."""
        return {
            name: [] if isinstance(default, list) else default if isinstance(default, int) else default.clone()
            for name, default in self._defaults.items()
        }

    def _run_with_state(self, state: Dict[str, Any], fn: Callable, args: tuple, kwargs: dict) -> Tuple[Any, Dict[str, Any]]:
        """Run ``fn`` against ``state`` swapped in; the instance's own state (and buffer
        bookkeeping) is swapped back in a ``finally``.  Returns ``fn``'s result and the new state."""
        pending = self._stash_host_buffers()
        own = self._copy_state()
        metas = {bname: dict(meta) for bname, meta in self._buffer_states.items()}
        swapped = self._state_swapped
        try:
            self._restore_state({**self.init_state(), **{k: local_value(v) for k, v in state.items()}})
            for meta in self._buffer_states.values():
                meta["owned"] = None  # an append copies the given buffer, never writes into it
            self._state_swapped = True
            out = fn(*args, **kwargs)
            return out, {name: getattr(self, name) for name in state}
        finally:
            self._state_swapped = swapped
            self._restore_state(own)
            for bname, meta in metas.items():
                self._buffer_states[bname].update(meta)
            self._unstash_host_buffers(pending)

    def apply_update(self, state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Pure update: ``(state, batch) -> state``.  Neither ``state`` nor the instance's
        own state changes; the update count is the caller's to keep."""
        self._check_input_devices(args, kwargs)
        _, new_state = self._run_with_state(state, self._update_impl, args, kwargs)
        return new_state

    def apply_compute(self, state: Dict[str, Any], axis_name: Optional[str] = None) -> Any:
        """Pure compute: ``state -> value``; syncs over ``axis_name`` if given.

        With ``axis_name`` every rank of the axis passes its own state (what
        :meth:`apply_update` made of its rows) and gets the all-rank value: the
        states go through an :class:`~metrics_tpu_torch.parallel.AxisBackend`
        over that axis (of the mesh this metric is placed on, else the default
        process group), the SPMD route of the JAX package's ``shard_map``.
        """
        if axis_name is not None:
            mesh = self._placement[0] if self._placement is not None and self._placement[1] == axis_name else None
            local = {k: local_value(v) for k, v in state.items()}
            state = self._sync_state_pure(local, AxisBackend(axis_name, mesh))
        value, _ = self._run_with_state(state, self._compute_impl, (), {})
        return value

    # ----------------------------------------------------------------- update
    @abstractmethod
    def update(self, *args: Any, **kwargs: Any) -> None:
        """Fold a batch into state."""

    @abstractmethod
    def compute(self) -> Any:
        """Compute the final value from (synced) state."""

    def _pre_update(self, *args: Any, **kwargs: Any) -> None:
        """Hook run on the inputs before each update (classification locks its input case here)."""

    def _stream_update(self, ids: torch.Tensor, num_streams: int, *args: Any, **kwargs: Any) -> Optional[Dict[str, torch.Tensor]]:
        """Per-stream sums of the states each row's own update adds, for a
        :class:`~metrics_tpu_torch.multistream.MultiStreamMetric` of this base:
        ``{state: (num_streams, ...)}`` (row ``i`` belongs to stream ``ids[i]``; an
        id of ``num_streams`` drops the row).  ``None``, the default, runs the
        update once per row under ``torch.func.vmap`` instead."""
        return None

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

    def _update_now(self, *args: Any, **kwargs: Any) -> None:
        if self._is_synced:
            raise MetricsTPUUserError(
                "The Metric has already been synced; re-syncing or updating while synced is forbidden."
            )
        if self._placement is not None:
            args, kwargs = _local_batch(args, kwargs)
        self._check_input_devices(args, kwargs)
        self._pre_update(*args, **kwargs)
        self._computed = None
        self._update_count += 1
        self._spanned_update_impl(*args, **kwargs)
        if self.compute_on_cpu:
            self._move_list_states_to_cpu()

    # the public update; forward's inner updates call _update_now, unspanned
    _update_wrapper = _obs.spanned("metric.update", _metric_labels)(_update_now)

    # the update body itself (input validation and the state update), under metric.update or metric.forward
    @_obs.spanned("metric.update_impl", _metric_labels)
    def _spanned_update_impl(self, *args: Any, **kwargs: Any) -> None:
        self._update_impl(*args, **kwargs)

    def _move_list_states_to_cpu(self) -> None:
        """Move list and buffer states to host memory (``compute_on_cpu``)."""
        cpu = torch.device("cpu")
        for name in self._defaults:
            value = getattr(self, name)
            if isinstance(value, list):
                setattr(self, name, [v.to(cpu) for v in value])
        for bname, meta in self._buffer_states.items():
            buf = getattr(self, bname + "__buf")
            if buf.device != cpu:
                buf = buf.to(cpu)
                setattr(self, bname + "__buf", buf)
                if meta["owned"] is not None:
                    meta["owned"] = buf

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
    @_obs.spanned("metric.forward", _metric_labels)
    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Update global state AND return the metric on this batch alone.

        The fast path merges the pre-update state with the batch state
        through the per-state reductions; the full path re-runs update on
        the cached global state.  With ``dist_sync_on_step`` the batch value
        is synced across processes (full path); with ``async_sync=True`` as
        well, the gather runs on the background worker instead and the value
        is the local batch's.
        """
        if self._is_synced:
            raise MetricsTPUUserError("Calling forward while the metric is synced is forbidden.")
        self._flush_host_buffers()
        # custom callables, sketches and None-reduce *tensor* states have no
        # O(1) merge rule — route them through the full re-update path (a
        # sketch's batch value comes from a fresh default state, whose key is
        # the seed's, and the batch never merges into the live state)
        no_fast_merge = any(
            callable(fx) or fx == "sketch" or (fx is None and not isinstance(getattr(self, name), list))
            for name, fx in self._reduce_fns.items()
        )
        if self.full_state_update or self.dist_sync_on_step or no_fast_merge:
            value = self._forward_full_state_update(*args, **kwargs)
        else:
            value = self._forward_reduce_state_update(*args, **kwargs)
        if self.compute_on_cpu:
            self._move_list_states_to_cpu()
        return value

    def _batch_value(self, should_sync: bool, args: tuple, kwargs: dict) -> Any:
        """Reset, update on this batch alone and compute, synced only when ``should_sync``."""
        self._reset_for_forward()
        self._update_now(*args, **kwargs)
        prev_sync = self.sync_on_compute
        self.sync_on_compute = should_sync
        try:
            return self._compute_wrapper()
        finally:
            self.sync_on_compute = prev_sync

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        self._update_now(*args, **kwargs)
        cache = self._copy_state()
        cached_count = self._update_count
        # the batch value syncs and resets a temporary delta cache: the batch
        # sync must vote "full", and its reset must not clear the prefix of
        # the accumulated state
        global_dc = self._delta_cache
        self._delta_cache = _DeltaCache()
        self._last_synced_state = None
        # opting in to an overlapped per-step sync makes the step's value the
        # local batch's (its gather runs in the background): hence `is True`
        async_round = self.dist_sync_on_step and self.async_sync is True
        try:
            batch_val = self._batch_value(self.dist_sync_on_step and not async_round, args, kwargs)
            batch_synced = self._last_synced_state
            batch_state = self._copy_state()
        finally:
            self._delta_cache = global_dc
            self._last_synced_state = None
        self._restore_state(cache)
        self._update_count = cached_count
        self._computed = None
        self._is_synced = False
        if async_round:
            # fold the previous round's gather, then start this step's on the
            # worker: the step pays the fold, never the wire
            self.sync_async()
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

    def merge_state(
        self,
        other_state: Union[Dict[str, Any], Sequence[Dict[str, Any]]],
        other_count: Optional[Union[int, Sequence[int]]] = None,
    ) -> None:
        """Fold other instances' states (what :meth:`state_pytree` returns) into this one.

        A sequence merges in one pass.  With ``other_count`` (each other
        instance's update count), ``mean`` states merge weighted by the counts
        and the update count grows by them; without it ``mean`` states average
        equally.  Buffer, list and ``cat`` states concatenate in order; sketch
        states fold through their ``merge_fn``.

        On a placed metric (:meth:`shard`) the other states are whole values
        (what :meth:`state_pytree` of any twin returns), each folded in as this
        rank's share of it (:meth:`_contribution_of`); ``Partial`` DTensor
        leaves (another placed metric's ``state``) are already shares.  The
        merged leaves keep the metric's placement (``sync.resharded_states``).
        """
        self._flush_host_buffers()
        others = [dict(other_state)] if isinstance(other_state, dict) else [dict(s) for s in other_state]
        for other in others:
            other.pop("_update_count", None)
        if self._placement is not None:
            others = [self._contribution_of(other) for other in others]
        if other_count is None:
            counts: Optional[List[float]] = None
        elif isinstance(other_count, (list, tuple)):
            counts = [float(c) for c in other_count]
        else:
            counts = [float(other_count)]
        if counts is not None and len(counts) != len(others):
            raise ValueError(f"`other_count` has {len(counts)} entries for {len(others)} state pytrees")
        parts_n = 1 + len(others)
        total = float(self._update_count) + sum(counts or [])
        if counts is not None and total:
            weights = [float(self._update_count) / total] + [c / total for c in counts]
        else:
            weights = [1.0 / parts_n] * parts_n
        skip = self._buffer_keys() | self._sketch_leaf_key_set()
        for bname, meta in self._buffer_states.items():
            bkey, lkey = bname + "__buf", bname + "__len"
            parts = [self.buffer_values(bname)] + [
                self._extract_buffer_values(_to_state_tensor(s[bkey], self.device), int(s[lkey]), bname) for s in others
            ]
            filled = [p for p in parts if p.shape[0]]
            if not filled:
                rows = parts[0]
            else:
                dtype = filled[0].dtype
                for p in filled[1:]:
                    dtype = _x32_dtype(torch.promote_types(dtype, p.dtype))
                rows = torch.cat([p.to(dtype) for p in filled])
            setattr(self, bkey, rows)
            setattr(self, lkey, int(rows.shape[0]))
            self._refresh_buffer_meta(bname)
            meta["owned"] = None
        for sname in self._sketch_states:
            own = {k: getattr(self, k) for k in self._sketch_leaf_keys(sname)}
            theirs = [{k: _to_state_tensor(s[k], self.device) for k in self._sketch_leaf_keys(sname)} for s in others]
            self._store_sketch_tree(sname, self._merge_sketches(sname, [own] + theirs))
        for name in self._defaults:
            if name in skip:
                continue
            value = getattr(self, name)
            fx = self._reduce_fns[name]
            theirs = [s[name] for s in others]
            if isinstance(value, list):
                merged: Any = list(value)
                for p in theirs:
                    merged.extend(p if isinstance(p, list) else [_to_state_tensor(p, self._list_device)])
                setattr(self, name, merged)
                continue
            parts = [value] + [_to_state_tensor(p, self.device) for p in theirs]
            if fx is None or fx == "cat":
                merged = torch.cat([torch.atleast_1d(p) for p in parts])
            elif fx in ("sum", "max", "min"):
                step = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}[fx]
                merged = parts[0]
                for p in parts[1:]:
                    merged = step(merged, p)
            elif fx == "mean":
                merged = weights[0] * parts[0]
                for w, p in zip(weights[1:], parts[1:]):
                    merged = merged + w * p
            elif callable(fx):
                merged = fx(torch.stack(parts))
            else:
                raise ValueError(f"cannot merge state {name!r} with reduce {fx!r}")
            setattr(self, name, merged)
        if counts is not None:
            self._update_count += int(sum(counts))
        self._computed = None
        self._delta_cache.clear()  # merged-in rows were never part of a gathered prefix
        self._reshard_after_restore()

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
        sketch_keys = self._sketch_leaf_key_set()
        for name, value in state.items():
            # a buffer's row count; sketch leaves hold ±inf padding by design
            if isinstance(value, int) or name in sketch_keys:
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
        one collective (or a sizes and a rows gather) per state, in state order.

        A backend that combines reductions (:class:`AxisBackend`,
        ``MeshBackend``: ``combine_reductions``) first reduces the reduced
        tensor states of one reduce, dtype and device in one collective each.
        Under such an SPMD backend a rank whose list state is still empty
        reaches that state's gather too: the backend's descriptor frame gives
        it the other ranks' row layout."""
        state = dict(state)
        delta_plan = delta_plan or {}
        spmd = not getattr(backend, "eager", True)
        if getattr(backend, "supports_packed", False):
            return self._sync_state_packed(state, backend, delta_plan)
        out: Dict[str, Any] = {}
        try:
            if getattr(backend, "combine_reductions", False):
                combined: Dict[Tuple[str, torch.dtype, torch.device], List[str]] = {}
                for name, value in state.items():
                    fx = self._reduce_fns[name]
                    if fx in _PARTIAL_OPS and isinstance(value, torch.Tensor) and name not in delta_plan:
                        combined.setdefault((fx, value.dtype, value.device), []).append(name)
                for (fx, _, _), names in combined.items():
                    with backend.annotate(names[0] if len(names) == 1 else f"{len(names)} {fx} states"):
                        out.update(zip(names, backend.reduce_many([state.pop(name) for name in names], fx)))
            for bname in self._buffer_states:
                bkey, lkey = bname + "__buf", bname + "__len"
                buf, cnt = state.pop(bkey), state.pop(lkey)
                with backend.annotate(bname):
                    gathered = backend.all_gather_cat(self._extract_buffer_values(buf, cnt, bname))
                out[bkey] = gathered
                out[lkey] = int(gathered.shape[0])
            for sname, smeta in self._sketch_states.items():
                keys = self._sketch_leaf_keys(sname)
                tree = {leaf: state.pop(key) for leaf, key in zip(smeta["leaves"], keys)}
                with backend.annotate(sname):
                    merged_tree = backend.all_gather_merge(tree, smeta["merge"])
                _obs.counter_inc("streaming.sketch_merge_calls", metric=type(self).__name__)
                out.update({key: merged_tree[leaf] for leaf, key in zip(smeta["leaves"], keys)})
            for name, value in state.items():
                with backend.annotate(name):
                    if isinstance(value, list):
                        if not value:
                            gathered = backend.all_gather_cat(None, device=self._list_device) if spmd else None
                            out[name] = value if gathered is None else gathered
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
        Sketch leaves travel whole (there is no appended suffix to cut) and
        fold through the sketch's ``merge_fn`` in rank order.
        """
        payload: Dict[str, torch.Tensor] = {}
        out: Dict[str, Any] = {}
        on_host = {"c." + name for name, value in state.items() if isinstance(value, list) and self._host_list_states}
        cat_names: List[str] = []
        reduce_names: List[str] = []
        for key in self._sketch_leaf_key_set():
            payload["s." + key] = state.pop(key)
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
        with _obs.span("sync.reduce", **_metric_labels(self)):
            per_rank = [
                {key: t if key in on_host else t.to(self.device) for key, t in _unpack_state_blob(s).items()}
                for s in shards
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
            for sname in self._sketch_states:
                merged_tree = self._merge_sketches(sname, [{k[2:]: v for k, v in r.items() if k.startswith("s.")} for r in per_rank])
                _obs.counter_inc("streaming.sketch_merge_calls", metric=type(self).__name__)
                out.update({f"{sname}__sk_{leaf}": value for leaf, value in merged_tree.items()})
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
                if wm and not _rows_unchanged(value, dc.locals.get(name), wm):
                    return None  # an update rewrote gathered rows (Pearson's running moments)
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
        dc.locals.clear()
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
                dc.locals[name] = lv
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
                if not isinstance(total, list):
                    dc.locals[name] = total
            if not names:
                return
            dc.prefixes.clear()
            dc.prefixes.update(advanced_prefixes)
            dc.watermarks.clear()
            dc.watermarks.update(advanced_wms)
            dc.round = max(dc.round, 0) + 1
        except Exception:
            dc.clear()

    def _finish_sync_report(
        self, report: Dict[str, Any], backend: Backend, start: float, telemetry: Optional[Dict[str, Any]] = None
    ) -> None:
        """Stamp and file one sync's report; ``telemetry`` is the collectives' figures where the
        caller popped them itself (a background round), else they are popped from ``backend``."""
        report["duration_secs"] = round(time.perf_counter() - start, 6)
        tel = dict(telemetry) if telemetry is not None else backend.pop_telemetry() or {}
        report["retries"] = int(tel.pop("retries", 0))
        report["gather_calls"] = int(tel.pop("gather_calls", 0))
        report["bytes_gathered"] = int(tel.pop("bytes_gathered", 0))
        report.update(tel)
        self.last_sync_report = report
        self.sync_report_history.append(report)
        _obs.record_sync_report(type(self).__name__, report)

    @_obs.spanned("metric.sync", _metric_labels)
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

        An SPMD backend (:class:`~metrics_tpu_torch.parallel.AxisBackend`, the
        ``MeshBackend`` that :meth:`shard` installs) skips the preflight, the
        integrity checks and the delta protocol, as the JAX package's in-trace
        tier does.
        """
        if self._is_synced:
            raise MetricsTPUUserError("The Metric has already been synced.")
        self._flush_host_buffers()
        # the catch-up barrier: fold any round in flight first, so the sync
        # below ships only the rows past its snapshot and the result is the
        # bits of a purely synchronous history
        self._async_catchup()
        self._last_synced_state = None
        saved_options: Any = _UNSET
        if backend is None:
            backend = self.sync_backend
        if backend is None:
            backend = get_backend(self.process_group, self._sync_options(), axis_name=self.axis_name)
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
            eager = getattr(backend, "eager", True)
            backend_delta = eager and getattr(backend, "supports_delta", False) and custom_fn is None
            try:
                info = None
                if eager:
                    if self.validate_sync:
                        self._validate_state_integrity(self._copy_state(), "pre-sync")
                    preflight_kwargs: Dict[str, Any] = {}
                    if backend_delta:
                        delta_plan = self._build_delta_plan()
                        preflight_kwargs["delta_token"] = (
                            self._delta_cache.token(list(delta_plan)) if delta_plan else None
                        )
                    with _obs.span("sync.preflight", **_metric_labels(self)):
                        info = backend.preflight_check(self._schema_entries(), self._update_count, **preflight_kwargs)
                if info:
                    report.update(info)
                # delta only when EVERY rank voted a matching token
                delta_ok = bool(delta_plan) and bool((info or {}).get("delta_ok"))
                if custom_fn is not None:
                    new_state = custom_fn(self._copy_state(), dict(self._reduce_fns), backend)
                else:
                    new_state = self._sync_state_pure(self._copy_state(), backend, delta_plan if delta_ok else None)
                if eager and self.validate_sync:
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

    def sync_async(self, backend: Optional[Backend] = None) -> Optional[AsyncSyncHandle]:
        """Start one packed sync round on the background sync worker and
        return at once with its :class:`~metrics_tpu_torch.parallel.AsyncSyncHandle`.

        Double-buffered: at most one round is in flight, and a submit first
        folds the previous round's result in (the fold advances the delta
        cache, so the next synchronous sync ships only the rows appended
        after this call's snapshot).  The delta cache's ``(round, digest)``
        token orders the fold: the catch-up barrier at the head of
        :meth:`sync` (which ``compute`` reaches) re-verifies it across ranks,
        so results are bitwise those of the synchronous path.  A failed round
        is swallowed at the fold: the cache is cleared and the next sync is a
        full gather.

        On the card the snapshot is taken on the caller's stream and the
        round's device work runs on a side stream that waits for it, so the
        round neither reads a state before it is written nor waits for the
        kernels launched after this call.

        Returns ``None`` (nothing started) when async sync is off
        (``async_sync=False`` or ``METRICS_TPU_ASYNC_SYNC=0``), with a custom
        ``dist_sync_fn``, or when the backend cannot run a packed, delta-voted
        round off the caller's thread or has no peers.
        """
        if self._is_synced:
            raise MetricsTPUUserError("Cannot start an async sync on a synced Metric.")
        if self.async_sync is False:
            return None
        if backend is None:
            backend = self.sync_backend
        if backend is None:
            backend = get_backend(self.process_group, self._sync_options(), axis_name=self.axis_name)
        if (
            not getattr(backend, "supports_packed", False)
            or not getattr(backend, "supports_delta", False)
            or not getattr(backend, "supports_async", False)
            or not backend.is_distributed()
            or self.dist_sync_fn is not None
        ):
            return None
        # double buffer: fold the previous round before parking a new one
        self._async_catchup()
        self._flush_host_buffers()
        round_backend = backend.for_async()
        snapshot = self._copy_state()
        count = self._update_count
        entries = self._schema_entries()
        delta_plan = self._build_delta_plan()
        token = self._delta_cache.token(list(delta_plan)) if delta_plan else None
        dc = self._delta_cache
        stream, ready = _side_stream(self.device), None
        if stream is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))

        def round_fn() -> Tuple[Optional[Dict[str, Any]], bool, Dict[str, Any], Dict[str, Any]]:
            # runs on the background worker, through the backend's async twin:
            # a process group of its own (DistBackend.for_async) and figures
            # kept apart from the caller's syncs
            try:
                with _on_side_stream(stream, ready):
                    info = round_backend.preflight_check(entries, count, delta_token=token)
                    delta_ok = bool(delta_plan) and bool((info or {}).get("delta_ok"))
                    new_state = self._sync_state_pure(snapshot, round_backend, delta_plan if delta_ok else None)
            except BaseException as err:
                err.telemetry = round_backend.pop_telemetry() or {}  # the round's figures go with the failure
                raise
            return info, delta_ok, new_state, round_backend.pop_telemetry() or {}

        handle = submit_async_round(round_fn, label=type(self).__name__)
        dc.inflight = {
            "handle": handle,
            "snapshot": snapshot,
            "generation": dc.generation,
            "backend": backend,
        }
        _obs.counter_inc("sync.async_rounds", metric=type(self).__name__)
        return handle

    def _async_catchup(self) -> None:
        """Fold in the round in flight, waiting for it if it has not finished
        (the one catch-up barrier).  The fold installs the gathered rows as
        the next delta prefix and leaves the local state untouched, so a later
        synchronous sync gives the bits of a purely synchronous history."""
        dc = self._delta_cache
        inflight, dc.inflight = dc.inflight, None
        if inflight is None:
            return
        handle: AsyncSyncHandle = inflight["handle"]
        backend: Backend = inflight["backend"]
        waited = 0.0
        if not handle.done.is_set():
            _obs.counter_inc("sync.catchup_barriers", metric=type(self).__name__)
            barrier_start = time.perf_counter()
            handle.wait()
            waited = time.perf_counter() - barrier_start
        completed = handle.completed_at if handle.completed_at is not None else handle.submitted_at
        overlap = max(0.0, (completed - handle.submitted_at) - waited)
        report: Dict[str, Any] = {
            "backend": type(backend).__name__,
            "world_size": int(backend.world_size()),
            "fallback": None,
            "error": None,
            "async": True,
            "overlap_secs": round(overlap, 6),
        }
        try:
            info, delta_ok, new_state, telemetry = handle.result()
        except SyncError as err:
            # the round failed: drop the prefix induction so the next sync is
            # a full gather; correctness never rests on a round having landed
            dc.clear()
            report["error"] = f"{type(err).__name__}: {err}"
            report["fallback"] = "full_gather"
            self._finish_sync_report(report, backend, handle.submitted_at, getattr(err, "telemetry", {}))
            return
        except BaseException:
            dc.clear()
            raise
        if inflight["generation"] != dc.generation:
            return  # the cache was cleared while the round ran: it is stale
        if self.device.type == "cuda":
            # made on the worker's side stream, used from here on this one
            stream = torch.cuda.current_stream(self.device)
            for value in new_state.values():
                for leaf in value if isinstance(value, list) else [value]:
                    if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                        leaf.record_stream(stream)
        if info:
            report.update(info)
        if self.delta_sync:
            # _advance_delta_cache reads the watermarks' row counts and the
            # rows-unchanged references from self._cache: the submit-time
            # snapshot is what this round gathered
            saved_cache = self._cache
            self._cache = inflight["snapshot"]
            try:
                self._advance_delta_cache(new_state, delta_ok, report)
            finally:
                self._cache = saved_cache
        self._finish_sync_report(report, backend, handle.submitted_at, telemetry)

    # ---------------------------------------------------------------- compute
    @_obs.spanned("metric.compute", _metric_labels)
    def _compute_wrapper(self) -> Any:
        self._flush_host_buffers()
        if self._update_count == 0 and not self._update_called_warned:
            rank_zero_warn(
                f"The ``compute`` method of metric {type(self).__name__} was called before the "
                "``update`` method; this will lead to errors or nonsense values.",
                UserWarning,
            )
            self._update_called_warned = True
        if self._computed is not None and self.compute_with_cache:
            return self._computed
        with self.sync_context(should_sync=self.sync_on_compute):
            self._computed = _squeeze_if_scalar(self._compute_impl())
        return self._computed

    # ------------------------------------------------------------------ reset
    def reset(self) -> None:
        """Reset state to fresh copies of the defaults (a placed metric stays
        placed)."""
        self.__dict__["_host_scalar_acc"] = {}  # pending host sums belong to the cleared epoch
        self.__dict__.pop("_leader_pending", None)
        self._release_states()
        self._host_buffers_dirty = False
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
                buf = torch.zeros((cap,) + meta["trail"], dtype=meta["dtype"], device=self._buffer_device())
                setattr(self, bname + "__buf", buf)
                meta["owned"] = buf

    def _reset_for_forward(self) -> None:
        """The reset of ``forward``'s batch value: :meth:`reset`, unless a subclass keeps
        derived caches across it (MeanAveragePrecision's IoU cache)."""
        self.reset()

    def clone(self) -> "Metric":
        return copy.deepcopy(self)

    # ---------------------------------------------------- device and dtype
    def to_device(self, device: Union[str, torch.device]) -> "Metric":
        """Move every state (and the defaults a reset restores) to ``device``,
        which becomes the metric's device; buffer-state row counts stay host
        ints.  The delta cache is cleared (its prefixes lived on the old
        device), so the next sync is a full gather.  A placed metric stays on
        its mesh's device type."""
        device = _resolve_device(device)
        if self._placement is not None and device.type != self._placement[0].device_type:
            raise MetricsTPUUserError(
                f"{type(self).__name__} is placed on a {self._placement[0].device_type} mesh and cannot move "
                f"to {device}"
            )

        def move(value: Any) -> Any:
            if isinstance(value, list):
                return value if self._host_list_states else [v.to(device) for v in value]
            return value.to(device) if isinstance(value, torch.Tensor) else value

        for name in self._defaults:
            setattr(self, name, move(getattr(self, name)))
            self._defaults[name] = move(self._defaults[name])
        for meta in self._buffer_states.values():
            meta["owned"] = None
        self.device = device
        if self.async_sync is not False:
            _side_stream(device)
        self._computed = None
        self._delta_cache.clear()
        return self

    # ------------------------------------------------------- mesh placement
    def _state_spec(self, name: str, axis_name: str) -> Optional[Any]:
        """The effective ``PartitionSpec`` of one flat state key.

        Explicit ``add_state(spec=...)`` wins; otherwise the kind decides, as in
        the JAX package: row states (``cat``/list tensors, buffer rows) shard
        their leading axis (``P(axis)``), everything reduced or fixed-shape
        (sketch leaves, buffer counts) replicates (``None``).  A tensor state
        reduced by ``None`` is gathered as rows by the port's sync, so it is a
        row state here.
        """
        from metrics_tpu_torch.parallel.mesh import PartitionSpec

        explicit = self._specs.get(name)
        if explicit is not None:
            return explicit
        if name.endswith("__len") or name in self._sketch_leaf_key_set():
            return None
        if name.endswith("__buf") or self._reduce_fns.get(name) in ("cat", None):
            return PartitionSpec(axis_name)
        return None

    def _placed_view(self, name: str, value: Any) -> Any:
        """One state leaf of a placed metric as its placement describes it.

        Between syncs a reduced state is ``Partial`` over the axis (this rank's
        own sums, which a sync reduces).  A synced leaf holds the whole value on
        every rank, laid out by
        :func:`~metrics_tpu_torch.parallel.leaf_sharding` of its spec: rows
        ``Shard(0)`` where they split evenly over the axis, else
        ``Replicate()``.  Every other leaf stays plain: rows between syncs (each
        rank's own; a ``Shard(0)`` DTensor assumes ``torch.chunk``'s split,
        which the ranks' row counts do not keep, and DTensor's collectives on
        such a layout break a gloo group), sketch leaves and custom-reduced
        states (no placement says how their merge folds them), lists and
        buffer counts.
        """
        fx = self._reduce_fns.get(name)
        if not isinstance(value, torch.Tensor) or callable(fx) or name in self._sketch_leaf_key_set():
            return value
        from torch.distributed.tensor import DTensor, Partial

        from metrics_tpu_torch.parallel.mesh import _axis_dim, _local_piece, leaf_sharding, replicated

        mesh, axis_name = self._placement
        if self._is_synced and self._last_synced_state is not None:
            placements = leaf_sharding(mesh, value, self._state_spec(name, axis_name), axis_name)
            return DTensor.from_local(_local_piece(mesh, value, placements), mesh, placements, run_check=False)
        if fx not in _PARTIAL_OPS:
            return value
        dim = _axis_dim(mesh, axis_name)
        placements = tuple(Partial(_PARTIAL_OPS[fx]) if j == dim else p for j, p in enumerate(replicated(mesh)))
        return DTensor.from_local(value, mesh, placements, run_check=False)

    def _placed_leaf_count(self) -> int:
        """The state leaves a placement lays out: reduced and row states (not
        sketch leaves, custom-reduced states or buffer row counts)."""
        sketch = self._sketch_leaf_key_set()
        return sum(
            1
            for name, default in self._defaults.items()
            if name not in sketch and not isinstance(default, int) and not callable(self._reduce_fns.get(name))
        )

    def _axis_rank(self) -> Tuple[int, int]:
        """``(this rank's coordinate, size)`` along the placement's axis."""
        from metrics_tpu_torch.parallel.mesh import _axis_dim

        mesh, axis_name = self._placement
        dim = _axis_dim(mesh, axis_name)
        return int(mesh.get_local_rank(dim)), int(mesh.size(dim))

    def _contribution_of(self, states: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's share of whole state values (what a load or a merge into a
        placed metric installs), such that a sync of every rank's share gives
        the whole value back: a ``sum`` state on the axis's first rank only
        (zeros elsewhere), a ``mean``/``max``/``min`` state on every rank, rows
        split as ``torch.chunk`` splits them, a sketch or a custom-reduced state
        on the first rank only (the default elsewhere).  A ``Partial`` DTensor
        (another placed metric's ``state`` between syncs) is a share already
        and gives its local tensor; any other DTensor gives its whole value.
        """
        me, world = self._axis_rank()
        cls = _dtensor_type()
        states = dict(states)
        out: Dict[str, Any] = {}
        for name, value in list(states.items()):
            if cls is not None and isinstance(value, cls):
                if any(p.is_partial() for p in value.placements):
                    out[name] = value.to_local()
                else:
                    states[name] = value.full_tensor()
        sketch_keys = self._sketch_leaf_key_set()
        for bname in self._buffer_states:
            bkey, lkey = bname + "__buf", bname + "__len"
            if bkey not in states:
                continue
            rows = self._extract_buffer_values(_to_state_tensor(states[bkey], self.device), int(states[lkey]), bname)
            piece = _chunk_rows(rows, world, me)
            out[bkey], out[lkey] = piece, int(piece.shape[0])
        for name, value in states.items():
            if name in out:
                continue
            fx = self._reduce_fns.get(name)
            if world == 1 or fx in ("mean", "max", "min"):
                out[name] = value
            elif name in sketch_keys or callable(fx):
                out[name] = value if me == 0 else self._defaults[name].clone()
            elif fx == "sum":
                out[name] = value if me == 0 else torch.zeros_like(_to_state_tensor(value, self.device))
            elif isinstance(value, list):
                rows = [_to_state_tensor(v, self._list_device) for v in value]
                piece = _chunk_rows(torch.atleast_1d(dim_zero_cat(rows)), world, me) if rows else None
                out[name] = [piece] if piece is not None and piece.shape[0] else []
            elif isinstance(self._defaults.get(name), list):
                piece = _chunk_rows(torch.atleast_1d(_to_state_tensor(value, self._list_device)), world, me)
                out[name] = [piece] if piece.shape[0] else []
            else:
                out[name] = _chunk_rows(torch.atleast_1d(_to_state_tensor(value, self.device)), world, me)
        return out

    def _mesh_backend(self) -> Backend:
        """A mesh backend of the placement's own, for collectives outside a sync
        (whole-value reads): its telemetry never reaches a sync report."""
        from metrics_tpu_torch.parallel.mesh import MeshBackend

        mesh, axis_name = self._placement
        return MeshBackend(mesh, axis_name, options=self._sync_options())

    @contextmanager
    def _global_view(self) -> Iterator[None]:
        """Inside the block a placed metric holds its whole values (one sync's
        collectives over its mesh, reported nowhere); its own shares come back
        after.  An unplaced or synced metric holds its values as they are."""
        if self._placement is None or self._is_synced:
            yield
            return
        self._flush_host_buffers()
        local = self._copy_state()
        self._restore_state(self._sync_state_pure(local, self._mesh_backend()))
        try:
            yield
        finally:
            self._restore_state(local)

    def shard(self, mesh: Optional[Any] = None, axis_name: str = "batch", install_backend: bool = True) -> "Metric":
        """Place the metric's state on a device mesh.

        Each rank keeps updating and computing on its own plain tensors; the
        placement says how they make up the metric's value, and :attr:`state`
        shows it as DTensors (:meth:`_placed_view`): reduced states
        ``Partial`` between syncs, synced values laid out by their spec.
        Unless ``install_backend=False``, later syncs run through
        :class:`~metrics_tpu_torch.parallel.mesh.MeshBackend`: the mesh's own
        collectives, no preflight or packing.  ``mesh`` defaults to
        :func:`~metrics_tpu_torch.parallel.default_mesh` on the metric's device
        type.  Host-side sums are flushed first.

        Placement survives :meth:`reset`, restores and merges (which install
        this rank's share of the whole values they are given,
        ``sync.resharded_states``); it does not survive pickling: shard a
        deserialized metric again.  Counted as ``sync.mesh_placements`` (the
        leaves placed, :meth:`_placed_leaf_count`).
        """
        from metrics_tpu_torch.parallel.mesh import MeshBackend, _axis_dim, default_mesh

        mesh = mesh if mesh is not None else default_mesh(axis_name=axis_name, device=self.device.type)
        _axis_dim(mesh, axis_name)
        if mesh.device_type != self.device.type:
            raise ValueError(
                f"{type(self).__name__} keeps its state on {self.device}; a {mesh.device_type} mesh cannot hold it"
            )
        self._flush_host_buffers()
        self._placement = (mesh, axis_name)
        if install_backend:
            self.sync_backend = MeshBackend(mesh, axis_name=axis_name, options=self._sync_options())
        _obs.counter_inc("sync.mesh_placements", self._placed_leaf_count(), metric=type(self).__name__)
        return self

    #: the placement verb of the JAX package, for the same seam
    place = shard

    def _reshard_after_restore(self) -> None:
        """Count the leaves a restore or a merge installed into a placed metric
        (this rank's shares, which its placement describes) as
        ``sync.resharded_states``."""
        if self._placement is None:
            return
        _obs.counter_inc("sync.resharded_states", self._placed_leaf_count(), metric=type(self).__name__)

    def set_dtype(self, dst_type: torch.dtype) -> "Metric":
        """Cast the floating states to ``dst_type``; integer states and buffer
        row counts keep theirs.  As in the JAX package without 64-bit types,
        ``float64`` narrows to ``float32``.  The delta cache is cleared (its
        prefixes keep the old dtype).  A reset restores the defaults' dtypes.
        A placed metric casts each rank's local values and keeps its placement."""
        dst_type = _x32_dtype(dst_type)
        self._delta_cache.clear()

        def cast(v: Any) -> Any:
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                return v.to(dst_type)
            return v

        for name in self._defaults:
            value = getattr(self, name)
            setattr(self, name, [cast(v) for v in value] if isinstance(value, list) else cast(value))
        for bname, meta in self._buffer_states.items():
            self._refresh_buffer_meta(bname)
            meta["owned"] = getattr(self, bname + "__buf")  # the cast made a copy this metric owns
        self._computed = None
        return self

    def float(self) -> "Metric":  # type: ignore[override]
        return self.set_dtype(torch.float32)

    def double(self) -> "Metric":  # type: ignore[override]
        """``set_dtype(torch.float64)``: float32 states, as in the JAX package
        without 64-bit types."""
        return self.set_dtype(torch.float64)

    def half(self) -> "Metric":  # type: ignore[override]
        """``bfloat16`` states, as the JAX package defines ``half`` (not
        ``nn.Module.half``'s float16)."""
        return self.set_dtype(torch.bfloat16)

    # ------------------------------------------------------------ persistence
    def persistent(self, mode: bool = False) -> None:
        for name in self._persistent:
            self._persistent[name] = mode

    def _save_to_state_dict(self, destination: Dict[str, Any], prefix: str, keep_vars: bool) -> None:
        """Add the persistent states to ``state_dict()`` (a placed metric's whole
        values: a collective over its mesh, which every rank reaches)."""
        with self._global_view():
            self._flush_host_buffers()
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
        """Load states from ``load_state_dict``: tensors or numpy arrays, dtypes
        kept (a placed metric takes whole values and keeps its share of each)."""
        self._computed = None  # a cached compute() predates the loaded state
        loaded = {name: state_dict.pop(prefix + name) for name in self._defaults if prefix + name in state_dict}
        self._load_states(self._contribution_of(loaded) if self._placement is not None else loaded)
        self._reshard_after_restore()
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
        list states concatenated, buffer states trimmed to their valid rows.
        A placed metric gives its whole values as plain tensors (a collective
        over its mesh, which every rank reaches): those of an unplaced twin."""
        with self._global_view():
            self._flush_host_buffers()
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
                setattr(self, name, [_to_state_tensor(v, self._list_device) for v in value])
            elif isinstance(self._defaults[name], list):
                setattr(self, name, [_to_state_tensor(value, self._list_device)])
            else:
                setattr(self, name, _to_state_tensor(value, self.device))
        for bname in self._buffer_states:
            if bname + "__buf" in states:
                self._refresh_buffer_meta(bname)

    def load_state_pytree(self, tree: Dict[str, Any]) -> None:
        """Load what :meth:`state_pytree` returns (tensors or numpy arrays) onto
        this metric's device.  A placed metric keeps its share of each whole
        value and places it again (``sync.resharded_states``)."""
        tree = dict(tree)
        self._delta_cache.clear()  # loaded rows were never part of a gathered prefix
        self._computed = None  # a cached compute() predates the loaded state
        self._update_count = int(tree.pop("_update_count", 0))
        self._load_states(self._contribution_of(tree) if self._placement is not None else tree)
        self._reshard_after_restore()

    # -------------------------------------------------------------- pickling
    def __getstate__(self) -> Dict[str, Any]:
        self._flush_host_buffers()
        d = {key: _picklable(value) for key, value in self.__dict__.items()}
        # bound-method wrappers are reinstalled in __setstate__
        for key in ("update", "compute", "_update_impl", "_compute_impl"):
            d.pop(key, None)
        d["_cache"] = None
        d["_computed"] = None
        # a restored metric re-verifies from one full gather
        d["_delta_cache"] = None
        d["_last_synced_state"] = None
        # a mesh holds live process groups: neither the placement nor a mesh
        # backend crosses pickling.  The leaves go as this rank's shares, as an
        # unplaced metric's go as its rank's own state (the JAX package's global
        # arrays pickle whole): shard() a deserialized metric again, or sync it
        if self._placement is not None and self._axis_rank()[1] > 1:
            d["_pickled_share"] = self._axis_rank()
        d["_placement"] = None
        if getattr(d.get("sync_backend"), "mesh", None) is not None:
            d["sync_backend"] = None
        return d

    def __setstate__(self, d: Dict[str, Any]) -> None:
        share = d.pop("_pickled_share", None)
        super().__setstate__({key: _unpickled(value) for key, value in d.items()})
        for key, value in (("_specs", {}), ("_placement", None), ("axis_name", None)):
            self.__dict__.setdefault(key, value)
        if share is not None:
            warnings.warn(
                f"this {type(self).__name__} holds rank {share[0]}'s share of a metric placed over {share[1]} ranks: "
                "compute() gives the all-rank value only after shard() on that mesh or a sync over those ranks",
                UserWarning,
            )
        self._delta_cache = _DeltaCache()
        self._install_wrappers()

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """Keep only the kwargs the update signature accepts."""
        params = inspect.signature(self._update_impl).parameters
        if any(p.kind == p.VAR_KEYWORD for p in params.values()):
            return kwargs
        return {k: v for k, v in kwargs.items() if k in params}

    def __hash__(self) -> int:
        """The JAX package's hash (the class name and the identities of the
        state values, so it changes as an update rebinds them) with the
        instance's own identity added: ``==`` builds a composition here, so a
        set of modules (``named_modules``, ``.to()``) must never see two
        members of one compute group, which share their state tensors, as
        equal hashes."""
        hash_vals: List[Any] = [type(self).__name__, id(self)]
        for name in self._defaults:
            value = getattr(self, name)
            hash_vals.append(name)
            if isinstance(value, list):
                hash_vals.extend(id(v) for v in value)
            else:
                hash_vals.append(id(value))
        return hash(tuple(hash_vals))

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"

    # ----------------------------------------------------- operator algebra
    def __add__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.add, self, other)

    def __radd__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.add, other, self)

    def __sub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.subtract, self, other)

    def __rsub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.subtract, other, self)

    def __mul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.multiply, self, other)

    def __rmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.multiply, other, self)

    def __truediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.divide, self, other)

    def __rtruediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.divide, other, self)

    def __floordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_floor_divide, self, other)

    def __rfloordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(_floor_divide, other, self)

    def __mod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.remainder, self, other)

    def __rmod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.remainder, other, self)

    def __pow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.pow, self, other)

    def __rpow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.pow, other, self)

    def __matmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.matmul, self, other)

    def __rmatmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.matmul, other, self)

    def __and__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_and, self, other)

    def __rand__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_and, other, self)

    def __or__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_or, self, other)

    def __ror__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_or, other, self)

    def __xor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_xor, self, other)

    def __rxor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_xor, other, self)

    def __eq__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(torch.eq, self, other)

    def __ne__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(torch.ne, self, other)

    def __lt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.lt, self, other)

    def __le__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.le, self, other)

    def __gt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.gt, self, other)

    def __ge__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.ge, self, other)

    def __abs__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.abs, self, None)

    # the JAX package's quirks, kept: unary minus is -abs, unary plus is abs
    def __neg__(self) -> "CompositionalMetric":
        return CompositionalMetric(_neg, self, None)

    def __pos__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.abs, self, None)

    def __invert__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.logical_not, self, None)

    def __getitem__(self, idx: Any) -> "CompositionalMetric":
        return CompositionalMetric(lambda x: x[idx], self, None)


def _neg(x: torch.Tensor) -> torch.Tensor:
    return -torch.abs(x)


def _floor_divide(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``jnp.floor_divide``.  On floats it is the JAX package's divmod:
    ``(x - fmod(x, y)) / y``, one less where the remainder's sign is not
    ``y``'s, rounded half away from zero; a zero quotient keeps the sign of
    that division, where ``torch.floor_divide`` gives it the sign of ``x / y``."""
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    if not (x.is_floating_point() or y.is_floating_point()):
        return torch.floor_divide(x, y)
    mod = torch.fmod(x, y)
    div = (x - mod) / y
    div = torch.where((mod != 0) & (torch.sign(y) != torch.sign(mod)), div - 1, div)
    whole = torch.trunc(div)
    return torch.where(torch.abs(div - whole) >= 0.5, whole + torch.sign(div), whole)


class CompositionalMetric(Metric):
    """A lazy operator over its operands' computed values (counterpart of the
    JAX package's ``CompositionalMetric``).

    ``update`` and ``forward`` go to the operands that are metrics, ``compute``
    applies ``operator`` to their computed values.  A Python number operand
    becomes a tensor on the metric operands' device (int32 or float32, as the
    JAX package's ``jnp.asarray``).  The operands are submodules, so
    ``named_modules()`` and ``.to()`` reach them; its ``state_dict`` holds no
    state of theirs, as the JAX package's does not (the composition has no
    state of its own, and each operand keeps its own).
    """

    def __init__(
        self,
        operator: Callable,
        metric_a: Union[Metric, float, int, torch.Tensor, None],
        metric_b: Union[Metric, float, int, torch.Tensor, None],
    ) -> None:
        operands = [m for m in (metric_a, metric_b) if isinstance(m, Metric)]
        super().__init__(device=operands[0].device if operands else "cuda")
        self.op = operator
        self.metric_a = self._operand(metric_a)
        self.metric_b = self._operand(metric_b)

    def _operand(self, value: Any) -> Any:
        if isinstance(value, (numbers.Number, np.ndarray)) and not isinstance(value, Metric):
            return _to_state_tensor(value, self.device)
        return value

    def _sync_state_pure(self, state: Dict[str, Any], backend: Backend, delta_plan: Optional[Dict[str, tuple]] = None) -> Dict[str, Any]:
        return state  # the operands sync their own states

    def update(self, *args: Any, **kwargs: Any) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a._update_wrapper(*args, **self.metric_a._filter_kwargs(**kwargs))
        if isinstance(self.metric_b, Metric):
            self.metric_b._update_wrapper(*args, **self.metric_b._filter_kwargs(**kwargs))

    def _update_wrapper(self, *args: Any, **kwargs: Any) -> None:
        self._computed = None
        self._update_count += 1
        self._update_impl(*args, **kwargs)

    def compute(self) -> Any:
        val_a = self.metric_a._compute_wrapper() if isinstance(self.metric_a, Metric) else self.metric_a
        val_b = self.metric_b._compute_wrapper() if isinstance(self.metric_b, Metric) else self.metric_b
        if val_b is None:
            return self.op(val_a)
        return self.op(val_a, val_b)

    def _compute_wrapper(self) -> Any:
        return self._compute_impl()

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        val_a = (
            self.metric_a(*args, **self.metric_a._filter_kwargs(**kwargs))
            if isinstance(self.metric_a, Metric)
            else self.metric_a
        )
        val_b = (
            self.metric_b(*args, **self.metric_b._filter_kwargs(**kwargs))
            if isinstance(self.metric_b, Metric)
            else self.metric_b
        )
        if val_a is None:
            return None
        if val_b is None:
            if self.metric_b is None:
                return self.op(val_a)
            return None
        return self.op(val_a, val_b)

    def reset(self) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.reset()
        if isinstance(self.metric_b, Metric):
            self.metric_b.reset()
        self._update_count = 0
        self._computed = None

    def persistent(self, mode: bool = False) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.persistent(mode=mode)
        if isinstance(self.metric_b, Metric):
            self.metric_b.persistent(mode=mode)

    def state_dict(self, *args: Any, destination: Optional[Dict[str, Any]] = None, prefix: str = "", keep_vars: bool = False) -> Dict[str, Any]:  # type: ignore[override]
        """No state of the operands (see the class docstring)."""
        out: Dict[str, Any] = OrderedDict() if destination is None else destination
        self._save_to_state_dict(out, prefix, keep_vars)
        return out

    def load_state_dict(self, state_dict: Dict[str, Any], strict: bool = True, assign: bool = False) -> Any:  # type: ignore[override]
        """Takes what :meth:`state_dict` gives: nothing of the operands."""
        unexpected = sorted(state_dict)
        if strict and unexpected:
            raise RuntimeError(f"Unexpected key(s) in state_dict of {type(self).__name__}: {unexpected}")
        return _IncompatibleKeys([], unexpected)

    def __repr__(self) -> str:
        _op_metrics = f"(\n  {getattr(self.op, '__name__', 'op')}(\n    {self.metric_a!r},\n    {self.metric_b!r}\n  )\n)"
        return self.__class__.__name__ + _op_metrics
