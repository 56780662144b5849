"""Cross-process metric sync on ``torch.distributed`` (counterpart of ``metrics_tpu/parallel``)."""

from metrics_tpu_torch.parallel.backend import (
    Backend,
    DistBackend,
    LoopbackBackend,
    NullBackend,
    SyncOptions,
    find_schema_divergence,
    get_backend,
    guarded_collective,
    reduce_synced_state,
    schema_digest_rows,
)
from metrics_tpu_torch.parallel.faults import ChaosBackend, ChaosInjectedError, ChaosInjectedSyncError

__all__ = [
    "Backend",
    "ChaosBackend",
    "ChaosInjectedError",
    "ChaosInjectedSyncError",
    "DistBackend",
    "LoopbackBackend",
    "NullBackend",
    "SyncOptions",
    "find_schema_divergence",
    "get_backend",
    "guarded_collective",
    "reduce_synced_state",
    "schema_digest_rows",
]
