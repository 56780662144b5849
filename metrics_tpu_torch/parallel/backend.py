"""Collective backends for cross-process metric sync on ``torch.distributed``
(counterpart of ``metrics_tpu/parallel/backend.py``).

* :class:`DistBackend` — eager sync over a ``torch.distributed`` process
  group, the counterpart of the JAX package's ``MultihostBackend``.  Every
  gather is framed as there: a schema preflight first, uneven leading dims
  through sizes → pad to the largest → gather → trim, and a one-blob packed
  transport.
* :class:`LoopbackBackend` — a world of one with the same accounting.
* :class:`NullBackend` — single process: sync is the identity.

Async rounds (:meth:`Metric.sync_async`) run on one background thread per
process (:func:`submit_async_round`).  ``torch.distributed`` pairs
collectives by their order on a process group, so the worker's collectives
go over a process group of their own: the round runs through the backend
that :meth:`DistBackend.for_async` returns, bound to that group and created
on the main thread before the first round, so a round in flight never pairs
with a main-thread gather.

``get_backend()`` picks :class:`DistBackend` when a process group of more than
one rank is initialised, else :class:`NullBackend`.  ``dist_reduce_fx`` names
map onto gathers that are reduced in rank order on every rank
(``sum``/``mean``/``max``/``min``) or concatenated (``cat``).

Timeouts: a ``torch.distributed`` collective that a watchdog abandons leaves
its group's collective sequence out of step, and a retry through the same
group would pair with a peer's next collective.  So a :class:`DistBackend`
collective is never retried: a timeout or a failed collective marks the group
broken, and every later sync over that group raises :class:`SyncError` at
once (``on_sync_error="local"`` then keeps ``compute()`` alive).  Re-create
the process group to sync again.
"""

import dataclasses
import hashlib
import os
import queue
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from metrics_tpu_torch.obs import core as _obs
from metrics_tpu_torch.utils.exceptions import SyncDesyncError, SyncError, SyncTimeoutError


def _env_float(name: str) -> Optional[float]:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


@dataclasses.dataclass(frozen=True)
class SyncOptions:
    """Fault-tolerance knobs for eager collectives.

    ``timeout`` is per collective attempt in seconds (``None`` disables the
    watchdog); ``max_retries`` bounds re-attempts after a timeout or a
    transient collective error; ``backoff`` is the base sleep between
    attempts (doubled each retry).  Environment defaults:
    ``METRICS_TPU_SYNC_TIMEOUT`` / ``METRICS_TPU_SYNC_MAX_RETRIES`` /
    ``METRICS_TPU_SYNC_BACKOFF``.
    """

    timeout: Optional[float] = None
    max_retries: int = 0
    backoff: float = 0.5

    @classmethod
    def from_env(cls) -> "SyncOptions":
        timeout = _env_float("METRICS_TPU_SYNC_TIMEOUT")
        retries = _env_float("METRICS_TPU_SYNC_MAX_RETRIES")
        backoff = _env_float("METRICS_TPU_SYNC_BACKOFF")
        return cls(
            timeout=timeout,
            max_retries=int(retries) if retries is not None else 0,
            backoff=backoff if backoff is not None else 0.5,
        )

    @classmethod
    def resolve(
        cls,
        timeout: Optional[float] = None,
        max_retries: Optional[int] = None,
        backoff: Optional[float] = None,
    ) -> "SyncOptions":
        """Explicit values override env defaults; ``None`` falls through."""
        env = cls.from_env()
        return cls(
            timeout=timeout if timeout is not None else env.timeout,
            max_retries=int(max_retries) if max_retries is not None else env.max_retries,
            backoff=backoff if backoff is not None else env.backoff,
        )


class _WatchdogTimeout(Exception):
    """Internal marker: the guarded call's worker thread missed the deadline."""


def _call_with_deadline(fn: Callable[[], Any], timeout: Optional[float], label: str) -> Any:
    """Run ``fn`` on a watchdog thread; raise ``_WatchdogTimeout`` past the deadline.

    A collective is a blocking native call that cannot be interrupted, so on
    timeout the worker thread is abandoned (daemon: it cannot keep the process
    alive) and the caller gets control back.
    """
    if timeout is None:
        return fn()
    box: Dict[str, Any] = {}
    done = threading.Event()

    def runner() -> None:
        try:
            box["value"] = fn()
        except BaseException as err:  # noqa: BLE001 — must cross the thread
            box["error"] = err
        finally:
            done.set()

    t = threading.Thread(target=runner, daemon=True, name=f"mtpu-sync[{label}]")
    t.start()
    if not done.wait(timeout):
        raise _WatchdogTimeout(label)
    if "error" in box:
        raise box["error"]
    return box["value"]


def guarded_collective(
    fn: Callable[[], Any],
    options: SyncOptions,
    label: str = "collective",
    telemetry: Optional[Dict[str, Any]] = None,
) -> Any:
    """Execute one collective under the timeout + bounded retry/backoff policy.

    Timeouts raise :class:`SyncTimeoutError` after the retry budget is spent;
    transient exceptions are retried the same way and the original error
    re-raised when the budget runs out.  :class:`SyncError` subclasses raised
    by ``fn`` itself propagate at once: they are verdicts, not transients.
    """
    attempts = max(int(options.max_retries), 0) + 1
    start = time.perf_counter()
    last_error: Optional[BaseException] = None
    for attempt in range(attempts):
        if attempt:
            nap = options.backoff * (2 ** (attempt - 1))
            time.sleep(nap)
            if telemetry is not None:
                telemetry["backoff_secs"] = round(telemetry.get("backoff_secs", 0.0) + nap, 6)
        if telemetry is not None:
            telemetry["attempts"] = telemetry.get("attempts", 0) + 1
        try:
            value = _call_with_deadline(fn, options.timeout, label)
        except SyncError:
            raise
        except _WatchdogTimeout:
            last_error = None
            continue
        except Exception as err:  # transient collective error: retry, then re-raise
            last_error = err
            continue
        if telemetry is not None and attempt:
            telemetry["retries"] = telemetry.get("retries", 0) + attempt
        return value
    if telemetry is not None:
        telemetry["retries"] = telemetry.get("retries", 0) + attempts - 1
    if last_error is not None:
        raise last_error
    elapsed = time.perf_counter() - start
    raise SyncTimeoutError(
        f"collective {label!r} timed out after {attempts} attempt(s) x "
        f"{options.timeout}s ({elapsed:.2f}s elapsed); a peer is stalled or gone",
        state=label,
        timeout=options.timeout,
        attempts=attempts,
    )


def schema_digest_rows(entries: Sequence[Tuple[str, str]]) -> np.ndarray:
    """Fixed-size per-state digests of ``(name, signature)`` pairs.

    Returns a ``(S, 16)`` uint8 array: a constant-shape payload that can be
    gathered safely even when the underlying states have diverged.
    """
    rows = np.zeros((len(entries), 16), np.uint8)
    for i, (name, sig) in enumerate(entries):
        h = hashlib.blake2b(f"{name}|{sig}".encode(), digest_size=16)
        rows[i] = np.frombuffer(h.digest(), np.uint8)
    return rows


def find_schema_divergence(gathered: np.ndarray, my_rank: int) -> Optional[Tuple[int, int]]:
    """First ``(rank, state_index)`` whose digest differs from ours, else None.

    ``gathered`` is the ``(P, S, 16)`` stacked digest exchange.
    """
    mine = gathered[my_rank]
    for rank in range(gathered.shape[0]):
        if rank == my_rank:
            continue
        diff = np.nonzero((gathered[rank] != mine).any(axis=-1))[0]
        if diff.size:
            return rank, int(diff[0])
    return None


def _nbytes(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(getattr(x, "nbytes", 0))


def reduce_stack(stacked: torch.Tensor, reduce_fx: Union[str, Callable]) -> torch.Tensor:
    """Reduce a ``(P, ...)`` gathered stack over its ranks, in rank order.

    A left fold, rank 0 first, so every rank computes the same bits and an
    integer sum keeps its dtype (``torch.sum`` would widen int32 to int64).
    """
    if callable(reduce_fx):
        return reduce_fx(stacked)
    if reduce_fx == "mean" and not stacked.is_floating_point():
        stacked = stacked.to(torch.float32)
    step = {"sum": torch.add, "mean": torch.add, "max": torch.maximum, "min": torch.minimum}[reduce_fx]
    out = stacked[0]
    for rank in range(1, stacked.shape[0]):
        out = step(out, stacked[rank])
    if reduce_fx == "mean":
        out = out / stacked.shape[0]
    return out


#: the process group the async worker's collectives run over, per sync group:
#: ``{group: async group}``, keyed as :data:`_BROKEN_GROUPS` is
_ASYNC_GROUPS: Dict[Any, Any] = {}


class AsyncSyncHandle:
    """Future for one background sync round submitted via :func:`submit_async_round`.

    ``wait`` parks the caller until the worker finishes (the catch-up
    barrier); ``result`` re-raises whatever the round raised on the worker.
    Timestamps (``submitted_at`` / ``completed_at``, ``time.perf_counter``
    domain) let the caller attribute how much of the round's wall time was
    hidden behind other work (``sync.overlap_secs``).
    """

    __slots__ = ("label", "done", "value", "error", "submitted_at", "completed_at")

    def __init__(self, label: str) -> None:
        self.label = label
        self.done = threading.Event()
        self.value: Any = None
        self.error: Optional[BaseException] = None
        self.submitted_at = time.perf_counter()
        self.completed_at: Optional[float] = None

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)

    def result(self) -> Any:
        self.done.wait()
        if self.error is not None:
            raise self.error
        return self.value


class _AsyncSyncWorker:
    """The dedicated background sync thread (one per process).

    A single FIFO daemon thread drains whole sync rounds (preflight, packed
    gather, reassembly) off the caller's thread.  One worker, not one per
    metric, is a correctness requirement: rounds are submitted in SPMD
    program order on every rank, and a single FIFO consumer keeps that order,
    so the worker's collectives pair up across ranks on their process group.
    While idle the worker parks in an untimed ``queue.get`` holding no lock.
    """

    def __init__(self) -> None:
        self._q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        # guards lazy thread (re)start only; never held around queue ops
        self._start_lock = threading.Lock()

    def submit(self, fn: Callable[[], Any], label: str) -> AsyncSyncHandle:
        handle = AsyncSyncHandle(label)
        with self._start_lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._run, daemon=True, name="mtpu-async-sync")
                self._thread.start()
        self._q.put_nowait((fn, handle))
        return handle

    def _run(self) -> None:
        while True:
            fn, handle = self._q.get()
            try:
                handle.value = fn()
            except BaseException as err:  # noqa: BLE001 — crosses the thread
                handle.error = err
            handle.completed_at = time.perf_counter()
            handle.done.set()


_ASYNC_WORKER = _AsyncSyncWorker()


def submit_async_round(fn: Callable[[], Any], label: str = "sync") -> AsyncSyncHandle:
    """Run ``fn`` (one whole sync round) on the process-wide background sync
    worker and return immediately with its :class:`AsyncSyncHandle`."""
    return _ASYNC_WORKER.submit(fn, label)


class Backend:
    """Protocol for metric-state synchronization."""

    #: backends whose preflight exchange can vote on the incremental (delta)
    #: cat-state protocol: a metric may gather only the rows appended since
    #: its last successful sync and splice them onto a cached prefix
    supports_delta: bool = False

    #: backends that can coalesce a whole state sync into one packed
    #: byte-blob exchange (:meth:`all_gather_bytes`) instead of two
    #: collectives per state
    supports_packed: bool = False

    #: backends whose collectives may run on the background sync worker
    #: (:meth:`Metric.sync_async`) while the caller's thread goes on
    supports_async: bool = False

    #: label set by the caller (the metric's per-state sync loop) so timeout
    #: diagnostics and telemetry can name the state being gathered
    _label: Optional[str] = None

    @contextmanager
    def annotate(self, label: Optional[str]) -> Iterator["Backend"]:
        """Attribute the collectives issued inside the block to ``label``."""
        prev = self._label
        self._label = label
        try:
            yield self
        finally:
            self._label = prev

    def preflight_check(
        self,
        entries: Sequence[Tuple[str, str]],
        update_count: int = 0,
        delta_token: Optional[Tuple[int, int, int]] = None,
    ) -> Optional[Dict[str, Any]]:
        """Schema-agreement check before any state gather.

        ``entries`` are ``(state_name, signature)`` pairs.  Distributed
        backends exchange fixed-size digests and raise
        :class:`SyncDesyncError` naming the diverging rank and state.
        ``delta_token`` is this rank's incremental-sync proposal
        ``(round, digest_lo, digest_hi)``, or ``None`` to demand a full
        gather; delta-capable backends report ``delta_ok`` in the returned
        info only when every rank proposed the identical token.
        """
        return None

    def all_gather_bytes(self, payload: bytes) -> list:
        """Gather one opaque byte blob per rank (packed sync transport)."""
        raise NotImplementedError

    def for_async(self) -> "Backend":
        """The backend a background round (:meth:`Metric.sync_async`) runs its
        collectives through, made on the calling thread before the round is
        submitted.  It keeps its own telemetry and its own ``annotate`` label,
        so the round never mixes with a sync on the caller's thread.  A
        backend that keeps no per-call state may return itself."""
        return self

    def pop_telemetry(self) -> Optional[Dict[str, Any]]:
        """Return and reset collective-level telemetry, if the backend keeps any."""
        return None

    def is_distributed(self) -> bool:
        raise NotImplementedError

    def world_size(self) -> int:
        raise NotImplementedError

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def all_gather_cat(self, x: torch.Tensor) -> torch.Tensor:
        """Gather along dim 0 (concatenated across participants)."""
        raise NotImplementedError

    def all_gather_stack(self, x: torch.Tensor) -> torch.Tensor:
        """Gather with a new leading participant dim."""
        raise NotImplementedError

    def all_gather_merge(self, tree: Dict[str, torch.Tensor], merge_fn: Callable) -> Dict[str, torch.Tensor]:
        """Merge-on-gather for fixed-shape sketch states.

        Gathers every leaf with a leading participant dim (one stacked gather
        per leaf, in sorted leaf order), reassembles each rank's tree and folds
        them through ``merge_fn`` in rank order, so every rank computes the
        same merged sketch without a broadcast.
        """
        leaves = sorted(tree)
        stacked = {k: self.all_gather_stack(tree[k]) for k in leaves}
        ranks = int(stacked[leaves[0]].shape[0])
        if ranks == 1:
            return {k: stacked[k][0] for k in leaves}
        return merge_fn([{k: stacked[k][p] for k in leaves} for p in range(ranks)])


class NullBackend(Backend):
    def is_distributed(self) -> bool:
        return False

    def world_size(self) -> int:
        return 1

    def psum(self, x):
        return x

    pmean = pmax = pmin = all_gather_cat = psum

    def all_gather_stack(self, x):
        return x[None]


#: groups whose collective sequence an abandoned or failed collective left out
#: of step: ``{group: why}``, keyed by the group object (the default group for
#: ``group=None``)
_BROKEN_GROUPS: Dict[Any, str] = {}


class DistBackend(Backend):
    """Eager sync over a ``torch.distributed`` process group.

    Every gather runs under the ``options.timeout`` watchdog and is recorded
    in per-sync telemetry (gather count, bytes) until :meth:`pop_telemetry`.
    A timeout or a failed collective marks the group broken (see the module
    docstring): no collective is retried, later ones raise :class:`SyncError`
    at once.

    The wire: under NCCL every payload travels as a CUDA ``uint8`` tensor on
    the current device, under any other backend (gloo) as a CPU one; results
    come back on the device of the tensor that was gathered.
    """

    supports_delta = True
    supports_packed = True
    supports_async = True

    def __init__(self, group: Optional[Any] = None, options: Optional[SyncOptions] = None):
        self.group = group
        self.options = options if options is not None else SyncOptions.from_env()
        self._telemetry = {}

    def pop_telemetry(self) -> Optional[Dict[str, Any]]:
        out, self._telemetry = self._telemetry, {}
        return out

    def is_distributed(self) -> bool:
        return self.world_size() > 1

    def world_size(self) -> int:
        return dist.get_world_size(self.group)

    def rank(self) -> int:
        return dist.get_rank(self.group)

    def _group_key(self) -> Any:
        return self.group if self.group is not None else dist.group.WORLD

    def for_async(self) -> "DistBackend":
        """A backend over the process group the background worker's
        collectives run on, made once per sync group.  ``dist.new_group`` is
        itself a collective over the default group: every rank reaches it
        from its main thread in the same order, at its first
        :meth:`Metric.sync_async`."""
        key = self._group_key()
        if key not in _ASYNC_GROUPS:
            ranks = dist.get_process_group_ranks(key)
            _ASYNC_GROUPS[key] = dist.new_group(ranks=ranks, backend=dist.get_backend(self.group))
        return DistBackend(_ASYNC_GROUPS[key], self.options)

    def _wire_device(self) -> torch.device:
        if dist.get_backend(self.group) == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def _allgather(self, x: torch.Tensor) -> torch.Tensor:
        """``(P,) + x.shape`` on ``x``'s device; the payload travels as raw bytes."""
        world = self.world_size()
        flat = x.detach().reshape(-1).contiguous()
        raw = flat.view(torch.uint8).to(self._wire_device())
        parts = [torch.empty_like(raw) for _ in range(world)]
        dist.all_gather(parts, raw, group=self.group)
        shape = (world,) + tuple(x.shape)
        if not flat.numel():  # a zero-byte row cannot be viewed as a wider dtype
            return torch.empty(shape, dtype=x.dtype, device=x.device)
        return torch.stack(parts).to(x.device).view(x.dtype).reshape(shape)

    def _gather(self, x: Any) -> torch.Tensor:
        """Stacked cross-process gather: returns ``(P,) + x.shape``."""
        x = torch.as_tensor(x)
        label = self._label or "gather"
        key = self._group_key()
        if key in _BROKEN_GROUPS:
            raise SyncError(
                f"collective {label!r} refused: the process group is out of step since "
                f"{_BROKEN_GROUPS[key]}; re-create the process group to sync again"
            )
        self._telemetry["attempts"] = self._telemetry.get("attempts", 0) + 1
        try:
            with _obs.span("sync.collective", backend=type(self).__name__, state=label):
                out = _call_with_deadline(lambda: self._allgather(x), self.options.timeout, label)
        except _WatchdogTimeout:
            _BROKEN_GROUPS[key] = f"collective {label!r} timed out"
            raise SyncTimeoutError(
                f"collective {label!r} timed out after {self.options.timeout}s; a peer is "
                "stalled or gone (a torch.distributed collective is not retried: the "
                "process group is out of step until it is re-created)",
                state=label,
                timeout=self.options.timeout,
                attempts=1,
            ) from None
        except Exception as err:
            _BROKEN_GROUPS[key] = f"collective {label!r} failed ({type(err).__name__})"
            raise
        self._telemetry["gather_calls"] = self._telemetry.get("gather_calls", 0) + 1
        self._telemetry["bytes_gathered"] = self._telemetry.get("bytes_gathered", 0) + _nbytes(out)
        return out

    def preflight_check(
        self,
        entries: Sequence[Tuple[str, str]],
        update_count: int = 0,
        delta_token: Optional[Tuple[int, int, int]] = None,
    ) -> Optional[Dict[str, Any]]:
        """Exchange tiny per-state metadata digests before any state gather.

        Two fixed-shape gathers, a ``(P, 6)`` int32 meta row (registry size,
        update count, delta vote) and ``(P, S, 16)`` digests, accounted as
        ``preflight_calls``/``preflight_bytes`` apart from the state payload.
        """
        if not self.is_distributed():
            return None
        calls0 = self._telemetry.get("gather_calls", 0)
        bytes0 = self._telemetry.get("bytes_gathered", 0)
        try:
            return self._preflight_exchange(entries, update_count, delta_token, self.rank())
        finally:
            tel = self._telemetry
            dcalls = tel.get("gather_calls", 0) - calls0
            dbytes = tel.get("bytes_gathered", 0) - bytes0
            if dcalls:
                tel["gather_calls"] -= dcalls
                tel["preflight_calls"] = tel.get("preflight_calls", 0) + dcalls
            if dbytes:
                tel["bytes_gathered"] -= dbytes
                tel["preflight_bytes"] = tel.get("preflight_bytes", 0) + dbytes

    def _preflight_exchange(
        self,
        entries: Sequence[Tuple[str, str]],
        update_count: int,
        delta_token: Optional[Tuple[int, int, int]],
        me: int,
    ) -> Dict[str, Any]:
        flag, rnd, lo, hi = (1, *delta_token) if delta_token is not None else (0, 0, 0, 0)
        with self.annotate("preflight/schema"):
            row = torch.tensor([len(entries), int(update_count), flag, rnd, lo, hi], dtype=torch.int32)
            meta = self._gather(row).numpy().reshape(-1, 6)
        counts = meta[:, 0]
        if not (counts == counts[me]).all():
            bad = int(np.nonzero(counts != counts[me])[0][0])
            raise SyncDesyncError(
                f"metric state registry size diverged before sync: rank {bad} "
                f"registers {int(counts[bad])} sync state(s), rank {me} has "
                f"{len(entries)} — the peers are not running the same metric",
                rank=bad,
            )
        if entries:
            with self.annotate("preflight/digests"):
                gathered = self._gather(torch.from_numpy(schema_digest_rows(entries))).numpy()
            div = find_schema_divergence(gathered, me)
            if div is not None:
                rank, idx = div
                name, sig = entries[idx]
                raise SyncDesyncError(
                    f"metric state {name!r} diverged on rank {rank} before sync "
                    f"(local signature {sig!r}); gathering it would hang or "
                    "corrupt every rank",
                    rank=rank,
                    state=name,
                )
        votes = meta[:, 2:6]
        delta_ok = bool((votes[:, 0] == 1).all() and (votes == votes[0]).all())
        return {
            "peer_update_counts": [int(c) for c in meta[:, 1]],
            "delta_ok": delta_ok,
        }

    def psum(self, x):
        return reduce_stack(self._gather(x), "sum")

    def pmean(self, x):
        return reduce_stack(self._gather(x), "mean")

    def pmax(self, x):
        return reduce_stack(self._gather(x), "max")

    def pmin(self, x):
        return reduce_stack(self._gather(x), "min")

    def all_gather_stack(self, x):
        return self._gather(x)

    def all_gather_cat(self, x):
        """Uneven-shape-safe gather: sizes → pad to the largest → gather → trim."""
        x = torch.atleast_1d(torch.as_tensor(x))
        sizes = [int(s) for s in self._gather(torch.tensor(x.shape[0], dtype=torch.int32))]
        max_size = max(sizes)
        if all(s == max_size for s in sizes):
            return self._gather(x).reshape((-1,) + tuple(x.shape[1:]))
        pad = x.new_zeros((max_size - x.shape[0],) + tuple(x.shape[1:]))
        gathered = self._gather(torch.cat([x, pad]))  # (P, max, ...)
        return torch.cat([gathered[p, : sizes[p]] for p in range(len(sizes))])

    def all_gather_bytes(self, payload: bytes) -> list:
        """One logical gather of an opaque byte blob per rank: sizes →
        pad to the largest → gather → trim."""
        sizes = [int(s) for s in self._gather(torch.tensor(len(payload), dtype=torch.int32))]
        padded = torch.zeros(max(sizes), dtype=torch.uint8)
        if payload:
            padded[: len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
        gathered = self._gather(padded).reshape(len(sizes), -1).numpy()
        return [gathered[p, : sizes[p]].tobytes() for p in range(len(sizes))]


class LoopbackBackend(Backend):
    """Single-process stand-in for :class:`DistBackend` with real telemetry.

    A world of one: every gather is an identity, but each flows through the
    same accounting (``gather_calls`` / ``bytes_gathered`` / packed payloads
    / delta votes) as the distributed backend, so single-process tests can
    measure the shape of sync traffic.  ``preflight_check`` approves any
    non-null delta token: with one rank the agreement is trivially met.
    """

    supports_delta = True
    supports_packed = True
    supports_async = True

    def __init__(self, options: Optional[SyncOptions] = None):
        self.options = options if options is not None else SyncOptions.from_env()
        self._telemetry = {}

    def pop_telemetry(self) -> Optional[Dict[str, Any]]:
        out, self._telemetry = self._telemetry, {}
        return out

    def for_async(self) -> "LoopbackBackend":
        return LoopbackBackend(self.options)

    def is_distributed(self) -> bool:
        return True

    def world_size(self) -> int:
        return 1

    def rank(self) -> int:
        return 0

    def _count(self, nbytes: int) -> None:
        self._telemetry["gather_calls"] = self._telemetry.get("gather_calls", 0) + 1
        self._telemetry["bytes_gathered"] = self._telemetry.get("bytes_gathered", 0) + int(nbytes)

    def _count_preflight(self, nbytes: int) -> None:
        self._telemetry["preflight_calls"] = self._telemetry.get("preflight_calls", 0) + 1
        self._telemetry["preflight_bytes"] = self._telemetry.get("preflight_bytes", 0) + int(nbytes)

    def preflight_check(
        self,
        entries: Sequence[Tuple[str, str]],
        update_count: int = 0,
        delta_token: Optional[Tuple[int, int, int]] = None,
    ) -> Optional[Dict[str, Any]]:
        # the distributed backend's two metadata exchanges at world size 1:
        # a (1, 6) int32 meta row, then (1, S, 16) uint8 digest rows
        self._count_preflight(6 * 4)
        if entries:
            self._count_preflight(16 * len(entries))
        return {"peer_update_counts": [int(update_count)], "delta_ok": delta_token is not None}

    def psum(self, x):
        x = torch.as_tensor(x)
        self._count(_nbytes(x))
        return x

    pmean = pmax = pmin = psum

    def all_gather_cat(self, x):
        # a sizes exchange (one int32) before the row gather, as on the
        # distributed backend, so both transports account alike
        x = torch.atleast_1d(torch.as_tensor(x))
        self._count(4)
        self._count(_nbytes(x))
        return x

    def all_gather_stack(self, x):
        x = torch.as_tensor(x)
        self._count(_nbytes(x))
        return x[None]

    def all_gather_bytes(self, payload: bytes) -> list:
        # sizes exchange + padded blob gather at world size 1
        self._count(4)
        self._count(len(payload))
        return [payload]


def get_backend(process_group: Optional[Any] = None, options: Optional[SyncOptions] = None) -> Backend:
    """:class:`DistBackend` over ``process_group`` (the default group for
    ``None``) when ``torch.distributed`` is initialised with more than one
    rank in it, else :class:`NullBackend`.  ``options`` carries the
    timeout knobs to the distributed backend."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size(process_group) > 1:
        return DistBackend(process_group, options)
    return NullBackend()


def reduce_synced_state(value: Any, reduce_fx: Union[str, Callable, None], backend: Backend) -> Any:
    """Apply one state's ``dist_reduce_fx`` through the backend.

    ``value`` is a single tensor (tensor state) or one pre-concatenated by
    the caller (list state, ``cat``).
    """
    if reduce_fx == "sum":
        return backend.psum(value)
    if reduce_fx == "mean":
        return backend.pmean(value)
    if reduce_fx == "max":
        return backend.pmax(value)
    if reduce_fx == "min":
        return backend.pmin(value)
    if reduce_fx == "cat" or reduce_fx is None:
        return backend.all_gather_cat(value)
    if callable(reduce_fx):
        # custom reduction: gather a stacked view and let the callable fold it
        return reduce_fx(backend.all_gather_stack(value))
    raise ValueError(f"Unknown dist_reduce_fx: {reduce_fx!r}")

