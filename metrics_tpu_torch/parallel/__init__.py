"""Cross-process metric sync on ``torch.distributed``: eager process-group
sync, and mesh-axis collectives for metric state placed on a device mesh
(counterpart of ``metrics_tpu/parallel``)."""

from metrics_tpu_torch.parallel.backend import (
    AsyncSyncHandle,
    AxisBackend,
    Backend,
    DistBackend,
    LoopbackBackend,
    MultihostBackend,
    NullBackend,
    SyncOptions,
    axis_context,
    current_axis,
    find_schema_divergence,
    get_backend,
    guarded_collective,
    reduce_synced_state,
    schema_digest_rows,
    submit_async_round,
)
from metrics_tpu_torch.parallel.faults import ChaosBackend, ChaosInjectedError, ChaosInjectedSyncError
from metrics_tpu_torch.parallel.mesh import (
    MeshBackend,
    PartitionSpec,
    default_mesh,
    leaf_sharding,
    replicated,
    row_sharded,
)

__all__ = [
    "AsyncSyncHandle",
    "AxisBackend",
    "Backend",
    "ChaosBackend",
    "ChaosInjectedError",
    "ChaosInjectedSyncError",
    "DistBackend",
    "LoopbackBackend",
    "MeshBackend",
    "MultihostBackend",
    "NullBackend",
    "PartitionSpec",
    "SyncOptions",
    "axis_context",
    "current_axis",
    "default_mesh",
    "find_schema_divergence",
    "get_backend",
    "guarded_collective",
    "leaf_sharding",
    "reduce_synced_state",
    "replicated",
    "row_sharded",
    "schema_digest_rows",
    "submit_async_round",
]
