"""Durable streaming-eval service: the library as a long-running system
(counterpart of ``metrics_tpu/serve``, every module of it).

``metrics_tpu_torch.serve`` turns a set of metrics into a process you can
run for days: a bounded ingestion queue micro-batching records into
fixed-shape updates, a registry of named eval jobs (plain, windowed,
time-decayed, multistream) with device-side queries, a stdlib HTTP surface
(``/metrics``, ``/query``, ``/healthz``, ``POST /ingest``,
``POST /ingest_columns``), and a durability loop taking preemption-safe
checkpoints so a kill at any moment loses at most the unflushed tail.  A
write-ahead log (:class:`WalWriter`) frames every accepted batch before the
ack; checkpoints carry applied-seq watermarks and a restarted server
replays exactly the frames past them (:func:`replay_frames`).

The server has no device of its own: it serves the metrics it is given, on
the device they keep their state on (``"cuda"`` unless they were built with
``device="cpu"``).  Every job of one registry lives on one device.

Quick start::

    from metrics_tpu_torch import MeanSquaredError
    from metrics_tpu_torch.checkpoint import CheckpointManager
    from metrics_tpu_torch.serve import EvalServer, MetricRegistry, ServeConfig

    registry = MetricRegistry()
    registry.register("mse", MeanSquaredError())      # device="cpu" without a GPU
    manager = CheckpointManager("/ckpts/evals", max_staleness=30.0)
    server = EvalServer(registry, ServeConfig(port=9100), manager).start()
    server.submit("mse", (0.9, 1.0))
    # GET :9100/metrics  |  GET :9100/query?job=mse  |  GET :9100/healthz
    server.stop()        # drain + final checkpoint

One server not enough?  The **sharded fleet** scales the same service
horizontally: a :class:`ShardRouter` span-partitions every multistream
job's stream axis across N workers (plain jobs place whole via a
consistent-hash ring), a :class:`FleetCoordinator` frontend stages ingest
in pre-allocated columnar rings (:class:`ColumnRing`) and forwards per
shard, scatter-gathers ``top_k`` / ``where`` / ``compute`` with exact
single-worker semantics, fails a dead shard over to a replacement restored
from its own checkpoint directory (and, with ``FleetSpec.wal_root``, its
write-ahead log), and resizes live (:func:`migration_plan`, the
:class:`Autoscaler` policy).  :class:`LocalFleet` runs N in-process workers
on one device (``FleetSpec.device``, ``"cuda"`` by default);
``python -m metrics_tpu_torch.serve.worker`` runs one shard as a process of
its own behind an :class:`HTTPShard`.  :class:`ColumnTraffic`,
:func:`run_load` and :func:`run_process_load` generate load, and
``metrics_tpu_torch.serve.soak`` drills kill→restore.
"""

from metrics_tpu_torch.serve.autoscaler import (
    Autoscaler,
    AutoscalerConfig,
    FleetSignals,
    autoscale_step,
)
from metrics_tpu_torch.serve.columnar import ColumnRing
from metrics_tpu_torch.serve.coordinator import (
    FleetCoordinator,
    HTTPShard,
    make_fleet_http_server,
)
from metrics_tpu_torch.serve.fleet import (
    FleetSpec,
    InProcessShard,
    JobSpec,
    LocalFleet,
    build_shard_registry,
)
from metrics_tpu_torch.serve.httpd import PooledHTTPServer
from metrics_tpu_torch.serve.loadgen import ColumnTraffic, LoadReport, run_load, run_process_load
from metrics_tpu_torch.serve.ingest import (
    BlockBatcher,
    ColumnBatch,
    IngestConsumer,
    IngestQueue,
    Record,
)
from metrics_tpu_torch.serve.registry import EvalJob, MetricRegistry
from metrics_tpu_torch.serve.router import (
    HashRing,
    MigrationPlan,
    ShardRouter,
    SpanMove,
    migration_plan,
)
from metrics_tpu_torch.serve.server import EvalServer, ServeConfig
from metrics_tpu_torch.serve.traffic import JobTraffic, TrafficGenerator, default_traffic
from metrics_tpu_torch.serve.wal import (
    WalCorruption,
    WalFrame,
    WalTicket,
    WalWriter,
    inject_wal_fault,
    replay_frames,
)

__all__ = [
    "Autoscaler",
    "AutoscalerConfig",
    "BlockBatcher",
    "ColumnBatch",
    "ColumnRing",
    "ColumnTraffic",
    "LoadReport",
    "EvalJob",
    "EvalServer",
    "FleetCoordinator",
    "FleetSignals",
    "FleetSpec",
    "HTTPShard",
    "HashRing",
    "InProcessShard",
    "IngestConsumer",
    "IngestQueue",
    "JobSpec",
    "JobTraffic",
    "LocalFleet",
    "MetricRegistry",
    "MigrationPlan",
    "PooledHTTPServer",
    "Record",
    "ServeConfig",
    "ShardRouter",
    "SpanMove",
    "TrafficGenerator",
    "WalCorruption",
    "WalFrame",
    "WalTicket",
    "WalWriter",
    "autoscale_step",
    "build_shard_registry",
    "default_traffic",
    "inject_wal_fault",
    "make_fleet_http_server",
    "migration_plan",
    "replay_frames",
    "run_load",
    "run_process_load",
]
