"""Multi-tenant metric streams: one Metric, S independent streams
(counterpart of ``metrics_tpu/multistream``).

:class:`MultiStreamMetric` turns a supported metric into ``num_streams``
independent streams backed by one set of stacked state tensors: per-user,
per-cohort or per-slice evaluation without a Python object per stream.
See ``docs/multistream.md``.
"""

from metrics_tpu_torch.multistream.core import MultiStreamMetric
from metrics_tpu_torch.multistream.sharding import (
    replicate_sharding,
    shard_spans,
    shard_streams,
    stream_mesh,
    stream_sharding,
)

__all__ = [
    "MultiStreamMetric",
    "shard_spans",
    "shard_streams",
    "stream_mesh",
    "stream_sharding",
    "replicate_sharding",
]
