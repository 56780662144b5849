"""Named evaluation jobs: the serve layer's metric registry (counterpart of
``metrics_tpu/serve/registry.py``).

An :class:`EvalJob` pairs one metric instance with a name, a lock, and the
export/query policy the HTTP surface needs; a :class:`MetricRegistry` is the
ordered collection of jobs one server hosts.  Three invariants the registry
enforces so request threads can never stall on the network:

* **No collectives on read paths.**  Registration forces
  ``sync_on_compute = False`` on every job metric — computes and stream
  queries read local state only.  Cross-host aggregation is the scraper's
  job (every replica exports its own gauges), or an explicit operator-driven
  ``sync`` outside the request path.
* **Single-writer state.**  All metric state mutation happens on the
  ingestion consumer thread; every state read (compute, query, export,
  checkpoint encode) takes the per-job lock, so HTTP threads and the
  durability loop never race the consumer.
* **Bounded exports.**  ``export_values`` never materializes a multistream
  job's full ``(num_streams, ...)`` value vector on the host: per-tenant
  jobs export aggregate gauges (active/dropped stream counts) plus an
  optional device-ranked ``top_k`` slice chosen at registration.

Every job of one registry keeps its state on one device: the checkpoint
target is one ``MetricCollection``, and a collection holds members of one
device only.  :meth:`MetricRegistry.register` refuses a metric on another
device; it never moves one.  Reads bring a value to the host with one
``.cpu()`` per tensor.
"""

from __future__ import annotations

import re
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.multistream import MultiStreamMetric
from metrics_tpu_torch.obs import core as _obs
from metrics_tpu_torch.streaming import TimeDecayedMetric, WindowedMetric
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

__all__ = ["EvalJob", "MetricRegistry"]

_JOB_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.:-]*$")

# predicate vocabulary for the HTTP `where` query (op, threshold) — kept as a
# table so the handler never eval()s anything
_WHERE_OPS: Dict[str, Callable[[Any, float], Any]] = {
    "gt": lambda v, t: v > t,
    "ge": lambda v, t: v >= t,
    "lt": lambda v, t: v < t,
    "le": lambda v, t: v <= t,
}


def _nested_floats(arr: np.ndarray) -> Any:
    if arr.ndim == 0:
        return float(arr)
    return [_nested_floats(row) for row in arr]


def _host(value: Any) -> np.ndarray:
    """One value on the host as a float64 array: a tensor comes over with one
    ``.cpu()`` (the read's only device-to-host copy), then widens."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.asarray(value, np.float64)


def _to_jsonable(value: Any) -> Any:
    """Host-side conversion of a computed value to JSON-friendly data."""
    if isinstance(value, dict):
        return {str(k): _to_jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_to_jsonable(v) for v in value]
    return _nested_floats(_host(value))


class EvalJob:
    """One named evaluation job: a metric, its lock, and its export policy.

    Args:
        name: registry key (also the ``job`` label on exported gauges).
        metric: the metric instance that accumulates this job's records.
        components: optional names for the elements of a vector-valued
            compute (e.g. ``("p50", "p99")`` for a two-quantile
            ``StreamingQuantile``); used as the ``component`` gauge label.
        export_top_k: for multistream jobs, export the k highest-valued
            streams as per-stream gauges (0 = aggregate gauges only).
        export_key: ``key=`` passed to the multistream ranking when the base
            compute is a dict/vector.
    """

    def __init__(
        self,
        name: str,
        metric: Metric,
        components: Optional[Sequence[str]] = None,
        export_top_k: int = 0,
        export_key: Any = None,
    ) -> None:
        self.name = name
        self.metric = metric
        self.components = None if components is None else tuple(str(c) for c in components)
        self.export_top_k = int(export_top_k)
        self.export_key = export_key
        # RLock: a checkpoint encode under the registry-wide lock sweep may
        # re-enter through metric hooks that take the same job's lock
        self.lock = threading.RLock()
        try:  # named in the runtime lock-witness graph; raw RLocks reject attrs
            self.lock.witness_name = f"EvalJob[{name}].lock"
        except AttributeError:
            pass
        self.records_ingested = 0  # host counter, consumer thread only
        self.blocks_dispatched = 0

    # ------------------------------------------------------------- inspection
    @property
    def is_multistream(self) -> bool:
        return isinstance(self.metric, MultiStreamMetric)

    @property
    def kind(self) -> str:
        if self.is_multistream:
            return "multistream"
        if isinstance(self.metric, WindowedMetric):
            return "windowed"
        if isinstance(self.metric, TimeDecayedMetric):
            return "time_decayed"
        return "plain"

    # ------------------------------------------------------------ state reads
    def compute(self) -> Any:
        """The job's computed value (device/host mix as the metric returns)."""
        with self.lock:
            return self.metric.compute()

    def compute_streams(self, stream_ids: Sequence[int]) -> Any:
        if not self.is_multistream:
            raise MetricsTPUUserError(
                f"job {self.name!r} is {self.kind}; per-stream reads need a "
                "MultiStreamMetric job"
            )
        with self.lock:
            return self.metric.compute_streams(np.asarray(list(stream_ids), np.int32))

    def top_k(self, k: int, key: Any = None, largest: bool = True) -> Tuple[Any, Any]:
        if not self.is_multistream:
            raise MetricsTPUUserError(
                f"job {self.name!r} is {self.kind}; stream ranking needs a "
                "MultiStreamMetric job"
            )
        with self.lock:
            return self.metric.top_k(k, key=key, largest=largest)

    def where_op(self, op: str, threshold: float, k: int, key: Any = None) -> Tuple[Any, Any]:
        """``where`` with a named comparison op — the HTTP-safe predicate."""
        if not self.is_multistream:
            raise MetricsTPUUserError(
                f"job {self.name!r} is {self.kind}; stream filtering needs a "
                "MultiStreamMetric job"
            )
        if op not in _WHERE_OPS:
            raise MetricsTPUUserError(
                f"unknown where-op {op!r}; expected one of {sorted(_WHERE_OPS)}"
            )
        fn = _WHERE_OPS[op]
        thr = float(threshold)
        with self.lock:
            return self.metric.where(lambda v: fn(v, thr), k=k, key=key)

    def advance_window(self) -> int:
        """Rotate a windowed job's ring (no-op guard for other kinds)."""
        if not isinstance(self.metric, WindowedMetric):
            raise MetricsTPUUserError(
                f"job {self.name!r} is {self.kind}; only windowed jobs advance"
            )
        with self.lock:
            return self.metric.advance()

    # --------------------------------------------------------------- exports
    def export_values(self) -> Any:
        """This job's gauge payload for ``metric_values_prometheus_text``.

        Scalar computes export as one gauge; dict computes as ``component``-
        labeled gauges; small vectors by ``components`` name (or index).
        Multistream jobs export ``active_streams`` / ``dropped_rows``
        aggregates plus, when ``export_top_k`` is set, the top-k streams as
        ``stream``-labeled gauges — never the full per-stream vector.
        """
        with self.lock:
            if self.is_multistream:
                out: List[Tuple[Dict[str, str], float]] = [
                    ({"component": "active_streams"}, float(self.metric.active_streams())),
                    ({"component": "dropped_rows"}, float(self.metric.dropped_rows())),
                ]
                if self.export_top_k > 0:
                    k = min(self.export_top_k, self.metric.num_streams)
                    values, ids = self.metric.top_k(k, key=self.export_key)
                    values = _host(values)
                    ids = _host(ids)
                    for v, i in zip(values, ids):
                        out.append(({"stream": str(int(i))}, float(v)))
                return out
            value = self.metric.compute()
        if isinstance(value, dict):
            return {str(k): float(_host(v)) for k, v in value.items()}
        arr = _host(value)
        if arr.ndim == 0:
            return float(arr)
        flat = arr.reshape(-1)
        names = self.components or [str(i) for i in range(flat.shape[0])]
        if len(names) != flat.shape[0]:
            raise MetricsTPUUserError(
                f"job {self.name!r} declares {len(names)} component name(s) for a "
                f"compute of {flat.shape[0]} element(s)"
            )
        return {name: float(v) for name, v in zip(names, flat)}


class MetricRegistry:
    """Ordered name -> :class:`EvalJob` map; the unit a server hosts and a
    :class:`~metrics_tpu_torch.checkpoint.CheckpointManager` snapshots."""

    def __init__(self) -> None:
        self._jobs: Dict[str, EvalJob] = {}
        self._ckpt_target: Optional[MetricCollection] = None

    @property
    def device(self) -> Optional[torch.device]:
        """The device every job keeps its state on (``None`` while empty)."""
        for job in self._jobs.values():
            return job.metric.device
        return None

    def _check_device(self, name: str, metric: Metric) -> None:
        device = self.device
        if device is not None and metric.device != device:
            raise MetricsTPUUserError(
                f"job {name!r} keeps its state on {metric.device}, but this registry's "
                f"jobs are on {device}: one registry serves one device (construct the "
                "metric with the same device=)"
            )

    def register(
        self,
        name: str,
        metric: Metric,
        components: Optional[Sequence[str]] = None,
        export_top_k: int = 0,
        export_key: Any = None,
    ) -> EvalJob:
        """Add a job.  Forces ``sync_on_compute = False`` on the metric (the
        no-collectives-on-read invariant), rejects duplicate names, and
        rejects a metric on another device than the registry's jobs.

        The JAX package also forces ``lazy_updates = 0`` here; the port's
        metrics update eagerly, so there is no lazy accumulation to turn off.
        """
        if not isinstance(metric, Metric):
            raise MetricsTPUUserError(
                f"job {name!r} needs a Metric instance, got {type(metric).__name__}"
            )
        if not _JOB_NAME_RE.match(name or ""):
            raise MetricsTPUUserError(
                f"job name {name!r} is not a valid label value; use letters, "
                "digits, and [_.:-]"
            )
        if name in self._jobs:
            raise MetricsTPUUserError(f"job name {name!r} already registered")
        self._check_device(name, metric)
        # request threads read local state only; see the module docstring
        metric.sync_on_compute = False
        metric.dist_sync_on_step = False
        job = EvalJob(
            name,
            metric,
            components=components,
            export_top_k=export_top_k,
            export_key=export_key,
        )
        self._jobs[name] = job
        self._ckpt_target = None
        _obs.counter_inc("serve.jobs_registered", metric=type(metric).__name__)
        return job

    def rebind(self, name: str, metric: Metric) -> EvalJob:
        """Swap a registered job's metric instance in place (elastic resize).

        The migration commit point on a worker: the staged post-resize
        metric replaces the live one under the job lock, so every reader
        (compute, export, checkpoint encode, batcher flush) sees either the
        old state or the new state, never a mix.  The same serve invariants
        ``register`` stamps are re-forced on the incoming metric, and the
        cached checkpoint target is invalidated so the next snapshot encodes
        the new instance.
        """
        if not isinstance(metric, Metric):
            raise MetricsTPUUserError(
                f"job {name!r} needs a Metric instance, got {type(metric).__name__}"
            )
        job = self[name]
        if metric.device != job.metric.device:
            raise MetricsTPUUserError(
                f"job {name!r} keeps its state on {job.metric.device}; the incoming metric is on {metric.device}"
            )
        metric.sync_on_compute = False
        metric.dist_sync_on_step = False
        with job.lock:
            job.metric = metric
            self._ckpt_target = None
        return job

    def unregister(self, name: str) -> EvalJob:
        """Remove a job (shard retirement after its state migrated away).

        Taken under the job lock so an in-flight read finishes against the
        old instance; the cached checkpoint target is invalidated so later
        snapshots stop encoding the departed job.
        """
        job = self[name]
        with job.lock:
            del self._jobs[name]
            self._ckpt_target = None
        return job

    # -------------------------------------------------------------- dict-ish
    def __getitem__(self, name: str) -> EvalJob:
        try:
            return self._jobs[name]
        except KeyError:
            raise KeyError(
                f"unknown job {name!r}; registered: {sorted(self._jobs)}"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._jobs

    def __iter__(self) -> Iterator[str]:
        return iter(self._jobs)

    def __len__(self) -> int:
        return len(self._jobs)

    def jobs(self) -> List[EvalJob]:
        return list(self._jobs.values())

    # ----------------------------------------------------------- bulk reads
    def compute_all(self) -> Dict[str, Any]:
        """Every job's computed value as JSON-friendly host data.  For
        multistream jobs this DOES materialize the full per-stream vector —
        it is the drill/debug path, not the scrape path."""
        return {name: _to_jsonable(job.compute()) for name, job in self._jobs.items()}

    def export_values(self) -> Dict[str, Any]:
        """The gauge payload ``obs.metric_values_prometheus_text`` renders."""
        return {name: job.export_values() for name, job in self._jobs.items()}

    def describe(self) -> List[Dict[str, Any]]:
        """Job inventory for ``/healthz``."""
        return [
            {
                "job": job.name,
                "kind": job.kind,
                "metric": type(job.metric).__name__,
                "records_ingested": job.records_ingested,
                "blocks_dispatched": job.blocks_dispatched,
            }
            for job in self._jobs.values()
        ]

    # ------------------------------------------------------------ durability
    def checkpoint_target(self) -> MetricCollection:
        """The registry as a checkpoint target: one ``MetricCollection`` over
        every job metric with compute-group sharing OFF — jobs are
        independent tenants and must never alias state."""
        if not self._jobs:
            raise MetricsTPUUserError("cannot checkpoint an empty registry")
        if self._ckpt_target is None:
            # construction mutates member metrics once (pending-update flush
            # + sync-policy stamping), so the one-time build takes the full
            # sweep; every later call returns the cached collection lock-free
            with self.locked():
                if self._ckpt_target is None:
                    self._ckpt_target = MetricCollection(
                        {name: job.metric for name, job in self._jobs.items()},
                        compute_groups=False,
                        device=self.device,
                    )
        return self._ckpt_target

    def locked(self) -> "_AllJobsLocked":
        """Context manager holding EVERY job lock (sorted by name, so the
        multi-lock sweep cannot deadlock against single-lock holders) — the
        full quiesce, now only needed for restore (which rewrites every
        job's state in place)."""
        return _AllJobsLocked(self.jobs())

    def lock_for_checkpoint_key(self, key: str) -> Any:
        """The per-job lock for one :func:`flatten_target` checkpoint key
        (``"col/{name}"``) — the ``lock_for`` hook of
        :meth:`CheckpointManager.encode_target`, so a snapshot encode holds
        one job lock at a time instead of quiescing the registry."""
        from contextlib import nullcontext

        name = key.split("/", 1)[1] if key.startswith("col/") else key
        job = self._jobs.get(name)
        return job.lock if job is not None else nullcontext()


class _AllJobsLocked:
    def __init__(self, jobs: List[EvalJob]) -> None:
        self._jobs = sorted(jobs, key=lambda j: j.name)

    def __enter__(self) -> None:
        for job in self._jobs:
            job.lock.acquire()

    def __exit__(self, *exc: Any) -> None:
        for job in reversed(self._jobs):
            job.lock.release()
