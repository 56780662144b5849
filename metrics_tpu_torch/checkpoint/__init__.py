"""Preemption-safe checkpointing of metric state (counterpart of ``metrics_tpu/checkpoint``).

See ``docs/checkpointing.md`` for the on-disk format, the elastic restore
semantics, and the failure policies.
"""

from metrics_tpu_torch.checkpoint.codec import (
    FORMAT_VERSION,
    SERIALIZERS,
    STATE_KIND_REGISTRARS,
    EncodedMetric,
    decode_metric,
    encode_metric,
    state_digest,
)
from metrics_tpu_torch.checkpoint.manager import (
    MANIFEST_NAME,
    CheckpointManager,
    RestoreResult,
    flatten_target,
    shard_checkpoint_directory,
)
from metrics_tpu_torch.checkpoint.store import ChaosStore, LocalStore
from metrics_tpu_torch.utils.exceptions import (
    CheckpointError,
    CheckpointIntegrityError,
    CheckpointRestoreError,
)

__all__ = [
    "FORMAT_VERSION",
    "MANIFEST_NAME",
    "SERIALIZERS",
    "STATE_KIND_REGISTRARS",
    "ChaosStore",
    "CheckpointError",
    "CheckpointIntegrityError",
    "CheckpointManager",
    "CheckpointRestoreError",
    "EncodedMetric",
    "LocalStore",
    "RestoreResult",
    "decode_metric",
    "encode_metric",
    "flatten_target",
    "shard_checkpoint_directory",
    "state_digest",
]
