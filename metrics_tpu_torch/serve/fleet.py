"""Fleet assembly: shard registries, in-process workers, checkpointed respawn
(counterpart of ``metrics_tpu/serve/fleet.py``).

This module is the **construction** side of the sharded serve tier — the
coordinator (``coordinator.py``) stays a pure request path and never
imports it.  Here live:

* :func:`build_shard_registry` — the per-shard registry: every multistream
  job re-registers at its span's width (same name, narrower stream axis);
  a plain job registers only on the one shard the router's hash ring owns
  it on.
* :class:`InProcessShard` — the duck-typed handle the coordinator drives
  when the whole fleet lives in one process (the fast tests and the
  bench); it copies ring views at the enqueue boundary, because the
  coordinator's ``commit`` frees the slots the views alias.
* :class:`LocalFleet` — N in-process :class:`EvalServer` workers, one
  coordinator, per-shard checkpoint directories, and the ``respawn``
  callback that makes :meth:`FleetCoordinator.failover` work: a
  replacement worker restores the dead shard's latest committed snapshot
  on start (restore-on-start is EvalServer's normal boot path), then the
  rows parked in the shard's staging ring drain into it.

Determinism note for the failover drill: with interval flushing disabled
(``flush_interval`` large), block dispatch boundaries depend only on each
shard's cumulative row count — the carry-buffered
:class:`~metrics_tpu_torch.serve.ingest.BlockBatcher` dispatches whole blocks no
matter how the rows were framed in flight — so a kill → respawn → drain
run is bitwise identical to an uninterrupted one.

Devices: a fleet keeps every shard's state on one device,
:attr:`FleetSpec.device` (``"cuda"`` unless ``"cpu"`` is asked for; without
CUDA the spec raises at construction, and nothing falls back to the CPU).
Each job's ``build()`` must return a metric on that device: a shard
registry refuses one on another device and never moves it.
"""
# analyze: skip-file[serve-blocking] -- the fleet layer owns worker
# construction and checkpoint restore-on-respawn: it wires the durability
# machinery the request-path modules (router/columnar/coordinator) are
# banned from touching.

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from metrics_tpu_torch.checkpoint.manager import (
    CheckpointManager,
    shard_checkpoint_directory,
)
from metrics_tpu_torch.metric import _resolve_device
from metrics_tpu_torch.multistream import MultiStreamMetric
from metrics_tpu_torch.obs import core as _obs
from metrics_tpu_torch.serve.coordinator import FleetCoordinator
from metrics_tpu_torch.serve.registry import MetricRegistry, _host, _to_jsonable
from metrics_tpu_torch.serve.router import ShardRouter
from metrics_tpu_torch.serve.server import EvalServer, ServeConfig
from metrics_tpu_torch.serve.wal import WalWriter
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

__all__ = [
    "JobSpec",
    "FleetSpec",
    "build_router",
    "build_shard_registry",
    "InProcessShard",
    "LocalFleet",
]


@dataclass
class JobSpec:
    """One job, fleet-wide.

    ``build`` returns a FRESH metric instance each call — every shard (and
    every respawn) constructs its own state, on the fleet's device (e.g.
    ``functools.partial(MeanSquaredError, device="cpu")``).  ``num_streams``
    is the *global* stream axis; ``None`` marks a plain job placed whole by
    the hash ring.
    """

    name: str
    build: Callable[[], Any]
    num_streams: Optional[int] = None
    components: Optional[Sequence[str]] = None
    export_top_k: int = 0


@dataclass
class FleetSpec:
    """Everything needed to stand a fleet up (or respawn one shard of it).

    ``wal_root`` switches ingest from queue-ack to durable-ack: each shard
    gets a segmented :class:`~metrics_tpu_torch.serve.wal.WalWriter` under
    ``wal_root/shard_NNNN``, workers run with ``wal_exactly_once`` (seq
    dedup + applied-seq watermarks in their checkpoints), and failover
    replays the log — see ``docs/serving.md``'s loss-model table.
    ``wal_fsync=False`` keeps the frames (page cache durability, enough
    for SIGKILL drills) but skips the disk barrier; the bench sweep uses
    it to price the fsync itself.

    ``device`` is where every shard keeps its state: ``"cuda"`` (the
    default; construction raises when CUDA is absent) or ``"cpu"``.
    """

    num_shards: int
    jobs: Sequence[JobSpec]
    checkpoint_root: Optional[str] = None
    server_config: ServeConfig = field(default_factory=ServeConfig)
    vnodes: int = 64
    ring_capacity: int = 8192
    ingest_dtype: Any = np.float32
    max_staleness: Optional[float] = None  # arms per-shard durability loops
    query_timeout: float = 30.0
    wal_root: Optional[str] = None
    wal_segment_bytes: int = 4 << 20
    wal_fsync: bool = True
    device: str = "cuda"

    def __post_init__(self) -> None:
        _resolve_device(self.device)  # raises when CUDA is asked for and absent


def build_router(spec: FleetSpec) -> ShardRouter:
    return ShardRouter(
        spec.num_shards,
        {job.name: job.num_streams for job in spec.jobs},
        vnodes=spec.vnodes,
    )


def build_shard_registry(
    spec: FleetSpec, shard: int, router: ShardRouter
) -> MetricRegistry:
    """The registry shard ``shard`` hosts.

    Multistream jobs keep their fleet-wide name but wrap a fresh metric at
    exactly the span's width — local row ``r`` IS global stream
    ``lo + r``, which is what makes scatter-gather merges exact.  Plain
    jobs register only on their ring-owned shard.  A job whose ``build()``
    returns a metric on another device than ``spec.device`` raises.
    """
    device = _resolve_device(spec.device)
    registry = MetricRegistry()
    for job in spec.jobs:
        if job.num_streams is not None:
            width = router.span_width(job.name, shard)
            registry.register(
                job.name,
                MultiStreamMetric(
                    _built(job, device), num_streams=width, device=device
                ),
                components=job.components,
                export_top_k=min(job.export_top_k, width),
            )
        elif router.owner(job.name) == int(shard):
            registry.register(
                job.name,
                _built(job, device),
                components=job.components,
            )
    if len(registry) == 0:
        raise MetricsTPUUserError(
            f"shard {shard} hosts no jobs (all plain jobs hashed elsewhere); "
            "add a multistream job or shrink the fleet"
        )
    return registry


def _built(job: JobSpec, device: torch.device) -> Any:
    """A fresh metric from ``job.build()``, which must keep its state on
    ``device``: the fleet never moves a metric."""
    metric = job.build()
    if metric.device != device:
        raise MetricsTPUUserError(
            f"job {job.name!r} builds a metric on {metric.device}, but the "
            f"fleet serves on {device}: build it with device={str(device)!r}"
        )
    return metric


class InProcessShard:
    """Duck-typed shard handle over an in-process :class:`EvalServer`.

    Mirrors :class:`~metrics_tpu_torch.serve.coordinator.HTTPShard` exactly —
    including the JSON-shaped return values (``_to_jsonable`` floats), so
    a merge computed over in-process handles is bit-identical to one
    computed over the HTTP wire.  Every read goes through the job's
    :class:`~metrics_tpu_torch.serve.registry.EvalJob` (its lock, and the
    consumer's CUDA stream), so it sees every block queued before it.
    """

    def __init__(self, server: EvalServer) -> None:
        self.server = server
        self.last_checkpoint_wal_marks: Optional[Dict[str, int]] = None

    # --------------------------------------------------------------- ingest
    def ingest_columns(
        self,
        job: str,
        cols: Sequence[np.ndarray],
        stream_ids: Optional[np.ndarray] = None,
        seqs: Optional[Sequence[Tuple[Optional[int], int]]] = None,
    ) -> bool:
        # the coordinator's ring views go stale at commit(), and the server
        # uploads at flush, not at submit: copy at the enqueue boundary
        # (the HTTP handle serializes instead)
        owned = tuple(np.array(c, copy=True) for c in cols)
        ids = None if stream_ids is None else np.array(stream_ids, copy=True)
        return self.server.submit_columns(job, owned, stream_ids=ids, seqs=seqs)

    def ingest_rows(
        self, job: str, rows: Sequence[Tuple[Tuple[Any, ...], Optional[int]]]
    ) -> Tuple[int, int]:
        accepted = rejected = 0
        for values, stream_id in rows:
            ok = self.server.submit(job, values, stream_id=stream_id)
            accepted += int(ok)
            rejected += int(not ok)
        return accepted, rejected

    # ---------------------------------------------------------------- reads
    def compute(self, job: str) -> Any:
        return _to_jsonable(self.server.registry[job].compute())

    def compute_streams(self, job: str, local_ids: Sequence[int]) -> List[Any]:
        return _to_jsonable(
            self.server.registry[job].compute_streams(list(local_ids))
        )

    def top_k(
        self, job: str, k: int, key: Any = None, largest: bool = True
    ) -> Tuple[List[float], List[int]]:
        values, ids = self.server.registry[job].top_k(k, key=key, largest=largest)
        return (
            _to_jsonable(values),
            [int(i) for i in _host(ids).reshape(-1)],
        )

    def where(
        self, job: str, op: str, threshold: float, k: int, key: Any = None
    ) -> Tuple[List[int], int]:
        ids, total = self.server.registry[job].where_op(
            op, float(threshold), k=k, key=key
        )
        kept = [int(i) for i in _host(ids).reshape(-1) if int(i) >= 0]
        return kept, int(_host(total))

    # ------------------------------------------------------------- liveness
    def health(self) -> Dict[str, Any]:
        return self.server.health()

    def flush(self, timeout: float = 10.0) -> bool:
        return self.server.flush(timeout=timeout)

    def checkpoint(self) -> int:
        step = self.server.checkpoint_now()
        # duck-parity with HTTPShard: expose the committed watermarks so
        # the owner of the shard's WalWriter can truncate covered segments
        self.last_checkpoint_wal_marks = self.server.last_checkpoint_wal_marks
        return step

    # ------------------------------------------------------------- migration
    def _require_live(self) -> None:
        # the HTTP handle gets connection-refused from a dead worker; the
        # in-process handle must fail the same way, so a kill mid-migration
        # aborts the resize instead of silently reading a corpse's registry
        if self.server._stopped:
            raise MetricsTPUUserError("shard worker is stopped")

    def migrate_out(
        self, job: str, lo: Optional[int] = None, hi: Optional[int] = None
    ) -> Dict[str, Any]:
        self._require_live()
        return self.server.export_span(job, lo=lo, hi=hi)

    def migrate_in(
        self,
        job: str,
        width: Optional[int] = None,
        span_lo: int = 0,
        pieces: Sequence[Dict[str, Any]] = (),
        plain: bool = False,
    ) -> int:
        self._require_live()
        return self.server.import_span(
            job, width=width, span_lo=span_lo, pieces=tuple(pieces), plain=plain
        )

    def commit_migration(self, job: str) -> None:
        self._require_live()
        self.server.commit_migration(job)

    def discard_migration(self, job: Optional[str] = None) -> int:
        # abort path: stays callable on a dead worker (nothing to undo there)
        return self.server.discard_migration(job)

    def retire_job(self, job: str) -> None:
        self._require_live()
        self.server.retire_job(job)


class LocalFleet:
    """N in-process workers + one coordinator (tests and the bench).

    Subprocess workers (``python -m metrics_tpu_torch.serve.worker``) speak the
    same protocol through :class:`~metrics_tpu_torch.serve.coordinator.HTTPShard`;
    the slow soak drill wires those up itself.
    """

    def __init__(self, spec: FleetSpec) -> None:
        self.spec = spec
        self.router = build_router(spec)
        self._servers: List[Optional[EvalServer]] = [None] * spec.num_shards
        self.coordinator: Optional[FleetCoordinator] = None
        self._wal: Dict[int, WalWriter] = {}
        self._started = False

    # ------------------------------------------------------------- lifecycle
    def _wal_writer(self, shard: int) -> Optional[WalWriter]:
        """The shard's WalWriter, creating (and recovering) it on demand."""
        if self.spec.wal_root is None:
            return None
        writer = self._wal.get(shard)
        if writer is None:
            writer = WalWriter(
                os.path.join(self.spec.wal_root, f"shard_{shard:04d}"),
                segment_bytes=self.spec.wal_segment_bytes,
                fsync=self.spec.wal_fsync,
            )
            self._wal[shard] = writer
        return writer

    def start(self) -> "LocalFleet":
        if self._started:
            raise MetricsTPUUserError("LocalFleet.start() called twice")
        self._started = True
        handles = []
        for shard in range(self.spec.num_shards):
            self._wal_writer(shard)
            server = self._spawn_server(shard)
            self._servers[shard] = server
            handles.append(InProcessShard(server))
        self.coordinator = FleetCoordinator(
            self.router,
            handles,
            respawn=self._respawn,
            provision=self._provision,
            retire=self._retire_shard,
            ring_capacity=self.spec.ring_capacity,
            ingest_dtype=self.spec.ingest_dtype,
            query_timeout=self.spec.query_timeout,
            wal=self._wal if self.spec.wal_root is not None else None,
        ).start()
        return self

    def _manager(self, shard: int) -> Optional[CheckpointManager]:
        if self.spec.checkpoint_root is None:
            return None
        return CheckpointManager(
            directory=shard_checkpoint_directory(
                self.spec.checkpoint_root, shard
            ),
            max_staleness=self.spec.max_staleness,
        )

    def _spawn_server(
        self, shard: int, router: Optional[ShardRouter] = None
    ) -> EvalServer:
        registry = build_shard_registry(
            self.spec, shard, self.router if router is None else router
        )
        config = replace(
            self.spec.server_config,
            port=0,
            wal_exactly_once=self.spec.wal_root is not None,
        )
        server = EvalServer(
            registry,
            config=config,
            checkpoint_manager=self._manager(shard),
            builders={job.name: job for job in self.spec.jobs},
        )
        # restore-on-start: a respawn after kill_shard() picks the shard's
        # latest committed snapshot right back up
        server.start()
        return server

    def _respawn(self, shard: int) -> InProcessShard:
        # the coordinator's router is the live epoch (it may be ahead of
        # the fleet copy while a resize is mid-flight or has failed)
        router = (
            self.router if self.coordinator is None else self.coordinator.router
        )
        server = self._spawn_server(shard, router=router)
        self._servers[shard] = server
        return InProcessShard(server)

    def _provision(self, shard: int, router: ShardRouter) -> InProcessShard:
        """Coordinator resize callback: stand up a fresh worker for a shard
        a grow adds, registered at the NEW router's spans.  Its zero state
        is replaced by ``migrate_in`` before any row is routed to it."""
        shard = int(shard)
        writer = self._wal_writer(shard)
        if writer is not None and self.coordinator is not None:
            # grown shards get durable ingest too: the coordinator's map
            # was copied at construction, so register the new writer there
            self.coordinator._wal[shard] = writer
        server = self._spawn_server(shard, router=router)
        while len(self._servers) <= shard:
            self._servers.append(None)
        self._servers[shard] = server
        return InProcessShard(server)

    def _retire_shard(self, shard: int) -> None:
        """Coordinator resize callback: stop a worker a shrink removes (or
        a provisioned-then-aborted grow).  No final checkpoint — its state
        already migrated out (or never held anything)."""
        shard = int(shard)
        if shard < len(self._servers) and self._servers[shard] is not None:
            self._servers[shard].stop(final_checkpoint=False)
            self._servers[shard] = None
        writer = self._wal.pop(shard, None)
        if writer is not None:
            if self.coordinator is not None:
                self.coordinator._wal.pop(shard, None)
            writer.close()

    def server(self, shard: int) -> EvalServer:
        srv = self._servers[int(shard)]
        if srv is None:
            raise MetricsTPUUserError(f"shard {shard} is not running")
        return srv

    # -------------------------------------------------------------- drills
    def checkpoint_all(self) -> Dict[int, int]:
        """Flush + snapshot every shard; ``{shard: committed_step}``.

        With a WAL attached, each committed checkpoint's applied-seq
        watermarks then garbage-collect the shard's log: sealed segments
        every watermark covers can never be needed by a replay again.
        """
        steps: Dict[int, int] = {}
        for shard in range(self.spec.num_shards):
            server = self.server(shard)
            steps[shard] = server.checkpoint_now()
            writer = self._wal.get(shard)
            marks = server.last_checkpoint_wal_marks
            if writer is not None and marks:
                writer.truncate_covered(marks)
        return steps

    def kill_shard(self, shard: int) -> None:
        """Preemption: drop the shard's queue, no final checkpoint.  The
        coordinator keeps parking its rows until :meth:`failover`."""
        self.server(shard).kill()
        _obs.counter_inc("serve.fleet_shard_kills", shard=str(shard))

    def failover(self, shard: int) -> InProcessShard:
        if self.coordinator is None:
            raise MetricsTPUUserError("fleet is not started")
        return self.coordinator.failover(shard)

    def resize(
        self,
        num_shards: int,
        timeout: float = 60.0,
        phase_hook: Optional[Callable[[str], None]] = None,
    ) -> Dict[str, Any]:
        """Live resize with a durability floor under the coordinator's
        migration protocol: every shard checkpoints at the **quiesced**
        phase — after the holds and flushes, before any state moves — so a
        worker killed mid-migration loses nothing that ``failover`` plus a
        retried resize cannot restore.  On success the fleet's spec and
        router track the new epoch and a fresh checkpoint pins the resized
        state."""
        if self.coordinator is None:
            raise MetricsTPUUserError("fleet is not started")
        n = int(num_shards)
        durable = self.spec.checkpoint_root is not None

        def _hook(phase: str) -> None:
            if phase == "quiesced" and durable:
                self.checkpoint_all()
            if phase_hook is not None:
                phase_hook(phase)

        summary = self.coordinator.resize(n, timeout=timeout, phase_hook=_hook)
        self.spec = replace(self.spec, num_shards=n)
        self.router = self.coordinator.router
        del self._servers[n:]
        if durable:
            self.checkpoint_all()
        return summary

    def stop(self, final_checkpoint: bool = False) -> None:
        if self.coordinator is not None:
            self.coordinator.stop()
        for shard, server in enumerate(self._servers):
            if server is not None:
                server.stop(final_checkpoint=final_checkpoint)
        for writer in self._wal.values():
            writer.close()
        self._wal = {}
