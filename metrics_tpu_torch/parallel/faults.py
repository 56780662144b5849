"""Chaos-injection backend: deterministic fault schedules for sync testing
(counterpart of ``metrics_tpu/parallel/faults.py``).

:class:`ChaosBackend` wraps any :class:`Backend` and injects faults from a
seeded deterministic schedule:

* ``delay`` — sleep before the collective (trips the watchdog when the sleep
  exceeds ``sync_timeout``; with retries, one scheduled delay gives the
  retry-then-succeed path).
* ``drop`` — the collective never completes (a dead peer: the call parks on
  an event until the watchdog gives up).
* ``corrupt`` — the collective completes but its float payload is
  NaN-poisoned (caught by ``validate_sync=True``).
* ``error`` — the collective raises a transient ``ChaosInjectedError``.
* ``desync`` — the pre-flight schema exchange sees a diverged peer.
* ``stall`` — every collective sleeps ``stall_secs`` (recurring latency).

Faults are one-shot: a retry of the same collective runs without the fault,
so ``schedule={0: "delay"}`` with ``max_retries=1`` recovers.  Collective
indices count every psum/pmean/pmax/pmin/gather/preflight call on the
instance, in order, exactly as the JAX package counts them, so one schedule
hits the same collectives in both packages.

Usage::

    chaos = ChaosBackend(NullBackend(), schedule={0: ("delay", 1.0)}, world_size=2)
    metric = Accuracy(..., sync_backend=chaos, sync_timeout=0.2, sync_max_retries=1)
"""

import copy
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.obs import core as _obs
from metrics_tpu_torch.parallel.backend import (
    Backend,
    SyncOptions,
    _nbytes,
    find_schema_divergence,
    guarded_collective,
    schema_digest_rows,
)
from metrics_tpu_torch.utils.exceptions import SyncDesyncError, SyncError

FaultSpec = Union[str, Tuple[str, Any]]

_FAULT_KINDS = ("delay", "drop", "corrupt", "error", "desync", "stall")
_FAULT_EXCEPTION_MODES = ("chaos", "sync_error")


class ChaosInjectedError(RuntimeError):
    """Transient failure injected by :class:`ChaosBackend` (retryable)."""


class ChaosInjectedSyncError(ChaosInjectedError, SyncError):
    """Injected failure that IS a :class:`SyncError`: the guard propagates it
    unretried, straight into a metric's ``on_sync_error`` policy.  Selected
    with ``ChaosBackend(fault_exception="sync_error")``."""


def _leaves(value: Any) -> list:
    if isinstance(value, (list, tuple)):
        return [leaf for v in value for leaf in _leaves(v)]
    if isinstance(value, dict):
        return [leaf for v in value.values() for leaf in _leaves(v)]
    return [value]


def _nan_poison(value: Any) -> Any:
    """Overwrite the first element of every float tensor leaf with NaN."""
    if isinstance(value, (list, tuple)):
        return type(value)(_nan_poison(v) for v in value)
    if isinstance(value, dict):
        return {k: _nan_poison(v) for k, v in value.items()}
    if isinstance(value, torch.Tensor) and value.is_floating_point():
        value = value.clone()
        if value.numel():
            value.view(-1)[0] = float("nan")
    return value


class ChaosBackend(Backend):
    """Fault-injection wrapper around any :class:`Backend`.

    Args:
        inner: the real backend every collective delegates to.
        schedule: ``{collective_index: fault}`` where fault is a kind string
            or ``(kind, arg)`` (``("delay", secs)``, ``("drop", secs)``).
        seed / fault_probs: probabilistic mode — each collective draws from
            ``np.random.default_rng(seed)``; the same seed and call order give
            the same faults.
        world_size: simulated world size when ``inner`` is not distributed
            (single-process tests then take the multi-rank failure paths;
            collectives still return inner's local values).
        delay_secs / drop_secs: default durations for ``delay`` / ``drop``.
        stall_secs: recurring per-collective latency (``0.0`` disables it).
        options: guard options for the chaos layer itself.
        packed: opt in to the packed one-blob transport (off by default: it
            would renumber every per-state fault schedule).
        fault_exception: ``"chaos"`` or ``"sync_error"`` (see
            :class:`ChaosInjectedSyncError`).
    """

    def __init__(
        self,
        inner: Backend,
        schedule: Optional[Dict[int, FaultSpec]] = None,
        seed: int = 0,
        fault_probs: Optional[Dict[str, float]] = None,
        world_size: Optional[int] = None,
        delay_secs: float = 0.05,
        drop_secs: float = 60.0,
        stall_secs: float = 0.0,
        options: Optional[SyncOptions] = None,
        packed: Optional[bool] = None,
        fault_exception: str = "chaos",
    ):
        if fault_exception not in _FAULT_EXCEPTION_MODES:
            raise ValueError(
                f"`fault_exception` must be one of {_FAULT_EXCEPTION_MODES}, got {fault_exception!r}"
            )
        self.fault_exception = fault_exception
        self.inner = inner
        self._packed = bool(packed) if packed is not None else False
        self.schedule = dict(schedule or {})
        for fault in self.schedule.values():
            kind = fault[0] if isinstance(fault, tuple) else fault
            if kind not in _FAULT_KINDS:
                raise ValueError(f"unknown fault kind {kind!r}; expected one of {_FAULT_KINDS}")
        self.fault_probs = dict(fault_probs or {})
        self._rng = np.random.default_rng(seed)
        self._world = world_size
        self.delay_secs = delay_secs
        self.drop_secs = drop_secs
        self.stall_secs = stall_secs
        self.options = options if options is not None else SyncOptions.from_env()
        self.op_index = 0
        self.injected: list = []  # (op_index, kind) log for assertions
        self._telemetry = {}
        self._drop_event = threading.Event()  # never set: a drop parks here
        self._fault_lock = threading.Lock()

    # ------------------------------------------------------------- scheduling
    def _next_fault(self) -> Tuple[int, Optional[str], Any]:
        # the caller's thread and the async worker (through the twin) draw from one sequence
        with self._fault_lock:
            idx = self.op_index
            self.op_index += 1
            fault = self.schedule.pop(idx, None)
            if fault is None and self.fault_probs:
                draw = self._rng.random()
                edge = 0.0
                for kind, prob in self.fault_probs.items():
                    edge += prob
                    if draw < edge:
                        fault = kind
                        break
            if fault is None:
                if self.stall_secs > 0:
                    fault = ("stall", self.stall_secs)
                else:
                    return idx, None, None
            kind, arg = fault if isinstance(fault, tuple) else (fault, None)
            self.injected.append((idx, kind))
        _obs.counter_inc("chaos.faults", kind=kind)
        return idx, kind, arg

    def _run(self, op: str, fn: Callable[[], Any]) -> Any:
        idx, kind, arg = self._next_fault()
        value = self._guarded(op, fn, idx, kind, arg)
        if not hasattr(self.inner, "_telemetry"):
            # over a telemetry-less inner (NullBackend) the chaos layer is the
            # only place the per-collective figures can be observed
            self._telemetry["gather_calls"] = self._telemetry.get("gather_calls", 0) + 1
            nbytes = sum(_nbytes(leaf) for leaf in _leaves(value))
            if nbytes:
                self._telemetry["bytes_gathered"] = self._telemetry.get("bytes_gathered", 0) + nbytes
        return value

    def _guarded(self, op: str, fn: Callable[[], Any], idx: int, kind: Optional[str], arg: Any) -> Any:
        consumed = {"pending": kind}

        def faulted() -> Any:
            # one-shot: the first attempt pays the fault, a retry runs clean
            k, consumed["pending"] = consumed["pending"], None
            exc = ChaosInjectedSyncError if self.fault_exception == "sync_error" else ChaosInjectedError
            if k == "delay":
                time.sleep(arg if arg is not None else self.delay_secs)
            elif k == "stall":
                time.sleep(arg if arg is not None else self.stall_secs)
            elif k == "drop":
                self._drop_event.wait(arg if arg is not None else self.drop_secs)
                raise exc(f"collective #{idx} ({op}) dropped by chaos schedule")
            elif k == "error":
                raise exc(f"collective #{idx} ({op}) failed by chaos schedule")
            out = fn()
            if k == "corrupt":
                out = _nan_poison(out)
            return out

        return guarded_collective(faulted, self.options, label=self._label or op, telemetry=self._telemetry)

    # ---------------------------------------------------------------- protocol
    @property
    def supports_packed(self) -> bool:  # type: ignore[override]
        return self._packed

    @property
    def supports_delta(self) -> bool:  # type: ignore[override]
        # delta slicing changes payload sizes but not the number or order of
        # collectives, so delegating keeps fault schedules stable
        return getattr(self.inner, "supports_delta", False)

    @property
    def supports_async(self) -> bool:  # type: ignore[override]
        # chaos injection is thread-agnostic (sleeps and raises work the same
        # on the background sync worker), so async eligibility is the inner
        # backend's call
        return getattr(self.inner, "supports_async", False)

    def for_async(self) -> "ChaosBackend":
        # the inner backend's twin and telemetry of its own; the fault
        # schedule stays one sequence across the caller's and the worker's
        # collectives, as on the JAX package's single instance
        twin = copy.copy(self)
        twin.inner = self.inner.for_async()
        twin._telemetry = {}
        twin._label = None
        twin._next_fault = self._next_fault
        return twin

    def is_distributed(self) -> bool:
        return self.inner.is_distributed() or (self._world or 1) > 1

    def world_size(self) -> int:
        if self._world is not None:
            return self._world
        return self.inner.world_size()

    def rank(self) -> int:
        return getattr(self.inner, "rank", lambda: 0)()

    def pop_telemetry(self) -> Optional[Dict[str, Any]]:
        out, self._telemetry = self._telemetry, {}
        for key, val in (self.inner.pop_telemetry() or {}).items():
            out[key] = out.get(key, 0) + val
        out["faults_injected"] = len(self.injected)
        return out

    def preflight_check(
        self,
        entries: Sequence[Tuple[str, str]],
        update_count: int = 0,
        delta_token: Optional[Tuple[int, int, int]] = None,
    ) -> Optional[Dict[str, Any]]:
        inner_kwargs: Dict[str, Any] = {}
        if getattr(self.inner, "supports_delta", False):
            inner_kwargs["delta_token"] = delta_token
        idx, kind, arg = self._next_fault()
        if kind == "desync":
            state_idx = int(arg) if arg is not None else 0
            if entries and self.inner.is_distributed():
                # real peers: perturb OUR digest so the genuine exchange
                # detects this rank as the diverged one on every peer
                entries = list(entries)
                name, sig = entries[min(state_idx, len(entries) - 1)]
                entries[min(state_idx, len(entries) - 1)] = (name, sig + "|chaos-desync")
                return self.inner.preflight_check(entries, update_count, **inner_kwargs)
            # single process: simulate the exchange — peer (world-1) diverges
            world = max(self.world_size(), 2)
            rows = schema_digest_rows(entries)
            if not len(entries):
                raise SyncDesyncError(
                    f"metric state registry size diverged before sync: rank {world - 1} "
                    f"registers 1 sync state(s), rank 0 has 0",
                    rank=world - 1,
                )
            gathered = np.stack([rows] * world)
            gathered[world - 1] = schema_digest_rows(
                [
                    (n, s + "|chaos-desync") if i == min(state_idx, len(entries) - 1) else (n, s)
                    for i, (n, s) in enumerate(entries)
                ]
            )
            rank, sidx = find_schema_divergence(gathered, 0)
            name, sig = entries[sidx]
            raise SyncDesyncError(
                f"metric state {name!r} diverged on rank {rank} before sync "
                f"(local signature {sig!r}); gathering it would hang or "
                "corrupt every rank",
                rank=rank,
                state=name,
            )
        if kind is not None:
            # non-desync faults apply to the underlying exchange collectives
            return self._guarded(
                "preflight",
                lambda: self.inner.preflight_check(entries, update_count, **inner_kwargs),
                idx,
                kind,
                arg,
            )
        return self.inner.preflight_check(entries, update_count, **inner_kwargs)

    # ------------------------------------------------------------- collectives
    def psum(self, x):
        return self._run("psum", lambda: self.inner.psum(x))

    def pmean(self, x):
        return self._run("pmean", lambda: self.inner.pmean(x))

    def pmax(self, x):
        return self._run("pmax", lambda: self.inner.pmax(x))

    def pmin(self, x):
        return self._run("pmin", lambda: self.inner.pmin(x))

    def all_gather_cat(self, x):
        return self._run("all_gather_cat", lambda: self.inner.all_gather_cat(x))

    def all_gather_stack(self, x):
        return self._run("all_gather_stack", lambda: self.inner.all_gather_stack(x))

    def all_gather_bytes(self, payload: bytes) -> list:
        # NaN-poisoning is a float-tensor transform, so a scheduled "corrupt"
        # on this op is a no-op; corruption tests stay on the per-state path
        return self._run("all_gather_bytes", lambda: self.inner.all_gather_bytes(payload))
