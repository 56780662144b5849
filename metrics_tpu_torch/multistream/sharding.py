"""Stream spans and mesh placement of a :class:`MultiStreamMetric`
(counterpart of ``metrics_tpu/multistream/sharding.py``).

:func:`shard_spans` cuts the stream axis into the contiguous spans a sharded
serve fleet gives its shards.  :func:`stream_mesh`, :func:`stream_sharding`,
:func:`replicate_sharding` and :func:`shard_streams` place a metric's states
on a :class:`~torch.distributed.device_mesh.DeviceMesh`.

In the JAX package one controller feeds every row, so the stacked
``(num_streams, ...)`` states can be split by stream across the devices.  In
the port each rank feeds its own rows, which may belong to any stream, so
every rank holds its own sums for every stream: a stacked reduced state is
placed as a ``Partial`` DTensor of the whole ``(num_streams, ...)`` shape, and
a sync reduces it.  :func:`stream_sharding` gives the placements of a value
split by stream (``Shard(0)``), for the caller's own DTensors.
"""

from typing import Any, List, Optional, Sequence, Tuple

from metrics_tpu_torch.multistream.core import MultiStreamMetric

__all__ = [
    "stream_mesh",
    "stream_sharding",
    "replicate_sharding",
    "shard_streams",
    "shard_spans",
]


def shard_spans(num_streams: int, num_shards: int) -> List[Tuple[int, int]]:
    """Contiguous, balanced half-open spans partitioning ``[0, num_streams)``.

    Span ``i`` is the slice of the stream axis shard ``i`` owns in a sharded
    serve fleet: the first ``num_streams % num_shards`` spans get the extra
    stream, sizes differ by at most one, and spans are ascending, so a global
    stream id maps to ``(shard, id - lo)`` with one comparison and the
    concatenation of per-shard results keeps the global stream order.
    """
    s, n = int(num_streams), int(num_shards)
    if n < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if s < n:
        raise ValueError(f"cannot cut {s} stream(s) into {n} non-empty shard span(s)")
    base, extra = divmod(s, n)
    spans: List[Tuple[int, int]] = []
    lo = 0
    for i in range(n):
        hi = lo + base + (1 if i < extra else 0)
        spans.append((lo, hi))
        lo = hi
    return spans


def stream_mesh(devices: Optional[Sequence[int]] = None, axis_name: str = "batch", device: str = "cuda") -> Any:
    """A 1-D device mesh over ``devices`` (ranks of the default process group,
    all by default) whose single axis carries the stream dimension."""
    from metrics_tpu_torch.parallel.mesh import default_mesh

    return default_mesh(devices, axis_name=axis_name, device=device)


def stream_sharding(mesh: Optional[Any] = None, axis_name: str = "batch") -> Tuple[Any, ...]:
    """DTensor placements splitting the leading (stream) axis across the mesh."""
    from metrics_tpu_torch.parallel.mesh import row_sharded

    return row_sharded(mesh if mesh is not None else stream_mesh(axis_name=axis_name), axis_name)


def replicate_sharding(mesh: Optional[Any] = None, axis_name: str = "batch") -> Tuple[Any, ...]:
    """DTensor placements of a value held whole on every rank of the mesh."""
    from metrics_tpu_torch.parallel.mesh import replicated

    return replicated(mesh if mesh is not None else stream_mesh(axis_name=axis_name))


def shard_streams(metric: MultiStreamMetric, mesh: Optional[Any] = None, axis_name: str = "batch") -> MultiStreamMetric:
    """Place a :class:`MultiStreamMetric`'s states on a device mesh.

    ``num_streams`` must divide over the mesh axis.  Delegates to
    :meth:`Metric.shard` (the one placement seam), so the placement is
    recorded and applied again after ``reset`` and a restore, counted as
    ``sync.mesh_placements``/``sync.resharded_states``.  No sync backend is
    installed: the metric keeps syncing through whatever backend it has.
    Returns the metric (placed in place).
    """
    from metrics_tpu_torch.parallel.mesh import _axis_dim

    mesh = mesh if mesh is not None else stream_mesh(axis_name=axis_name, device=metric.device.type)
    n_dev = int(mesh.size(_axis_dim(mesh, axis_name)))
    if metric.num_streams % n_dev:
        raise ValueError(f"num_streams={metric.num_streams} must divide evenly over the {n_dev}-rank mesh")
    return metric.shard(mesh, axis_name=axis_name, install_backend=False)
