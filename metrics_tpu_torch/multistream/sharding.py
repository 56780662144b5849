"""Stream spans (counterpart of ``metrics_tpu/multistream/sharding.py``, the part one device needs).

The JAX package also places a :class:`MultiStreamMetric`'s stacked states on a
device mesh (``stream_mesh``, ``stream_sharding``, ``replicate_sharding``,
``shard_streams``); those are JAX meshes, which the port does not have.
"""

from typing import List, Tuple

__all__ = ["shard_spans"]


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
