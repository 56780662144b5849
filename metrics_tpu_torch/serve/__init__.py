"""Durable streaming-eval service: the library as a long-running system
(counterpart of ``metrics_tpu/serve``, its single-process server and its
durability and routing pieces).

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

The routing pieces of the sharded fleet are here too (:class:`ShardRouter`,
:class:`HashRing`, :func:`migration_plan`, :class:`ColumnRing`, the
:class:`Autoscaler` policy); the fleet that drives them (the JAX package's
``coordinator``, ``fleet`` and ``worker``) and its load and soak harness
(``loadgen``, ``soak``) are not ported yet.
"""

from metrics_tpu_torch.serve.autoscaler import (
    Autoscaler,
    AutoscalerConfig,
    FleetSignals,
    autoscale_step,
)
from metrics_tpu_torch.serve.columnar import ColumnRing
from metrics_tpu_torch.serve.httpd import PooledHTTPServer
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
    "EvalJob",
    "EvalServer",
    "FleetSignals",
    "HashRing",
    "IngestConsumer",
    "IngestQueue",
    "JobTraffic",
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
    "default_traffic",
    "inject_wal_fault",
    "migration_plan",
    "replay_frames",
]
