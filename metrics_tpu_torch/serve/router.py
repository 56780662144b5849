"""Stream/job -> shard routing for the sharded serve fleet (counterpart of
``metrics_tpu/serve/router.py``: the same placements for the same keys).

Two placement rules, one router:

* **Multistream jobs** cut their stream axis ``[0, num_streams)`` into the
  contiguous, balanced spans of
  :func:`~metrics_tpu_torch.multistream.sharding.shard_spans`; shard ``i`` hosts
  a :class:`~metrics_tpu_torch.multistream.MultiStreamMetric` of exactly its
  span's width and a global stream id lands at local row ``id - lo``.
  Contiguity is what makes scatter-gather exact: per-shard results
  concatenated in shard order ARE the single-worker result in global
  stream order, and a merged top-k breaks ties lowest-global-id-first just
  like a top-k over the unsharded axis.
* **Plain jobs** (one scalar state, nothing to split) each live wholly on
  the shard a consistent-hash ring (:class:`HashRing`, blake2b over
  virtual nodes) picks from the job name — resizing the fleet from N to
  N+1 shards moves ~1/N of the plain jobs instead of reshuffling all of
  them.

The router is **read-only after construction**: request threads route with
no lock, no I/O, and no device work — ``tools/analyze``'s serve-blocking
and lock-order passes check this module with no opt-outs.

Out-of-range stream ids stay *deliberately routable*: they clamp to the
nearest span for placement but keep their out-of-range **local** offset,
so the owning worker's device-side drop lane counts them exactly as an
unsharded worker would (``dropped_rows`` parity under scatter).
"""

from __future__ import annotations

import hashlib
from bisect import bisect_right
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from metrics_tpu_torch.multistream.sharding import shard_spans
from metrics_tpu_torch.obs import core as _obs
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

__all__ = [
    "HashRing",
    "MigrationPlan",
    "ShardRouter",
    "SpanMove",
    "migration_plan",
]


def _ring_point(key: str) -> int:
    """64-bit ring position of a key (blake2b: stable across processes,
    unlike ``hash()`` with PYTHONHASHSEED)."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big"
    )


class HashRing:
    """Consistent-hash ring over shard indices with virtual nodes.

    Every shard projects ``vnodes`` points onto the 2^64 ring; a key owns
    the first point clockwise from its own hash.  More virtual nodes mean
    a flatter load split (stddev ~ 1/sqrt(vnodes)) at linear ring-build
    cost; lookups stay O(log(N * vnodes)).
    """

    def __init__(self, shards: Sequence[int], vnodes: int = 64) -> None:
        shards = [int(s) for s in shards]
        if not shards:
            raise MetricsTPUUserError("HashRing needs at least one shard")
        if int(vnodes) < 1:
            raise MetricsTPUUserError(f"vnodes must be >= 1, got {vnodes}")
        points: List[Tuple[int, int]] = []
        for shard in shards:
            for v in range(int(vnodes)):
                points.append((_ring_point(f"shard-{shard}#{v}"), shard))
        points.sort()
        self._points = [p for p, _ in points]
        self._owners = [s for _, s in points]

    def lookup(self, key: str) -> int:
        """The shard owning ``key``."""
        i = bisect_right(self._points, _ring_point(key)) % len(self._points)
        return self._owners[i]


class ShardRouter:
    """Maps ``(job, stream_id)`` to the worker shard that owns the state.

    Args:
        num_shards: fleet width; shards are indexed ``0..num_shards-1``.
        streams_by_job: ``{job_name: num_streams | None}`` — ``None`` marks
            a plain (unsplittable) job routed by the hash ring; an int is a
            multistream job whose stream axis is span-partitioned.
        vnodes: virtual nodes per shard on the plain-job ring.
    """

    def __init__(
        self,
        num_shards: int,
        streams_by_job: Dict[str, Optional[int]],
        vnodes: int = 64,
        epoch: int = 0,
    ) -> None:
        self.num_shards = int(num_shards)
        if self.num_shards < 1:
            raise MetricsTPUUserError(
                f"num_shards must be >= 1, got {num_shards}"
            )
        # routing generation: bumped by resized(); queries and workers can
        # tell "same layout rebuilt" from "layout actually changed"
        self.epoch = int(epoch)
        self._streams_by_job = dict(streams_by_job)
        self._vnodes = int(vnodes)
        self.ring = HashRing(range(self.num_shards), vnodes=vnodes)
        self._spans: Dict[str, List[Tuple[int, int]]] = {}
        self._bounds: Dict[str, np.ndarray] = {}
        self._plain_owner: Dict[str, int] = {}
        for job, num_streams in streams_by_job.items():
            if num_streams is None:
                self._plain_owner[job] = self.ring.lookup(job)
                continue
            try:
                spans = shard_spans(int(num_streams), self.num_shards)
            except ValueError as err:
                raise MetricsTPUUserError(
                    f"job {job!r} cannot shard {self.num_shards} ways: {err}"
                ) from None
            self._spans[job] = spans
            # span boundaries [lo_0, lo_1, ..., lo_{N-1}, S]: shard of id x
            # is searchsorted(bounds, x, 'right') - 1, clipped into range
            self._bounds[job] = np.asarray(
                [lo for lo, _ in spans] + [spans[-1][1]], np.int64
            )

    # -------------------------------------------------------------- inventory
    def jobs(self) -> List[str]:
        return sorted(list(self._spans) + list(self._plain_owner))

    def is_multistream(self, job: str) -> bool:
        self._known(job)
        return job in self._spans

    def _known(self, job: str) -> None:
        if job not in self._spans and job not in self._plain_owner:
            raise MetricsTPUUserError(
                f"unroutable job {job!r}; routed: {self.jobs()}"
            )

    def num_streams(self, job: str) -> int:
        """Total (global) stream-axis width of a multistream job."""
        self._known(job)
        if job in self._plain_owner:
            raise MetricsTPUUserError(f"plain job {job!r} has no stream axis")
        return int(self._bounds[job][-1])

    def span(self, job: str, shard: int) -> Tuple[int, int]:
        """Half-open global-stream span shard ``shard`` owns for ``job``."""
        self._known(job)
        if job in self._plain_owner:
            raise MetricsTPUUserError(f"plain job {job!r} has no stream spans")
        return self._spans[job][int(shard)]

    def span_width(self, job: str, shard: int) -> int:
        lo, hi = self.span(job, shard)
        return hi - lo

    def owner(self, job: str) -> int:
        """The single shard a plain job lives on (ring placement)."""
        self._known(job)
        if job in self._spans:
            raise MetricsTPUUserError(
                f"multistream job {job!r} spans every shard; route by stream_id"
            )
        return self._plain_owner[job]

    # ---------------------------------------------------------------- routing
    def shard_for(self, job: str, stream_id: Optional[int] = None) -> int:
        """The shard one record routes to."""
        self._known(job)
        if job in self._plain_owner:
            shard = self._plain_owner[job]
        else:
            if stream_id is None:
                raise MetricsTPUUserError(
                    f"job {job!r} is multistream; routing needs a stream_id"
                )
            bounds = self._bounds[job]
            i = int(np.searchsorted(bounds, int(stream_id), side="right")) - 1
            shard = min(max(i, 0), self.num_shards - 1)
        _obs.counter_inc("serve.shard_routes", shard=str(shard))
        return shard

    def local_id(self, job: str, stream_id: int) -> Tuple[int, int]:
        """``(shard, local_row)`` of a global stream id.  Out-of-range ids
        clamp to the edge shard but keep an out-of-range local offset, so
        the worker's device drop lane sees them (accounting parity)."""
        shard = self.shard_for(job, stream_id)
        lo, _hi = self._spans[job][shard]
        return shard, int(stream_id) - lo

    def global_id(self, job: str, shard: int, local_row: int) -> int:
        """Inverse of :meth:`local_id` for in-span rows."""
        lo, _hi = self.span(job, int(shard))
        return lo + int(local_row)

    def partition_ids(
        self, job: str, stream_ids: np.ndarray
    ) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        """Vectorized bulk route: ``{shard: (row_positions, local_ids)}``.

        ``row_positions`` index into the input order (so the caller can
        slice value columns per shard); ``local_ids`` are already span-
        relative.  One ``searchsorted`` for the whole batch — the hot
        frontend path never loops per record.
        """
        self._known(job)
        ids = np.asarray(stream_ids, np.int64).reshape(-1)
        if job in self._plain_owner:
            raise MetricsTPUUserError(
                f"plain job {job!r} does not partition by stream_id"
            )
        bounds = self._bounds[job]
        shards = np.clip(
            np.searchsorted(bounds, ids, side="right") - 1, 0, self.num_shards - 1
        )
        # group rows by shard with one stable sort: order keeps each
        # shard's rows in arrival order, and searchsorted over the sorted
        # shard column yields every shard's contiguous slice
        order = np.argsort(shards, kind="stable")
        sorted_shards = shards[order]
        starts = np.searchsorted(sorted_shards, np.arange(self.num_shards), "left")
        stops = np.searchsorted(sorted_shards, np.arange(self.num_shards), "right")
        out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for shard in range(self.num_shards):
            lo_i, hi_i = int(starts[shard]), int(stops[shard])
            if lo_i == hi_i:
                continue
            positions = order[lo_i:hi_i]
            lo = self._spans[job][shard][0]
            out[shard] = (positions, (ids[positions] - lo).astype(np.int32))
            _obs.counter_inc(
                "serve.shard_routes", hi_i - lo_i, shard=str(shard)
            )
        return out

    def owner_of_ids(self, job: str, stream_ids: np.ndarray) -> np.ndarray:
        """Owning shard of each GLOBAL stream id, vectorized, counter-free.

        The forwarder's ship-time lookup: rows staged under one routing
        epoch must re-resolve their owner under whatever epoch is live when
        they actually ship, so parked rows drain to the post-resize owner
        automatically.  No counters here — :meth:`partition_ids` already
        billed ``serve.shard_routes`` at ingest.
        """
        self._known(job)
        if job in self._plain_owner:
            raise MetricsTPUUserError(
                f"plain job {job!r} does not partition by stream_id"
            )
        ids = np.asarray(stream_ids, np.int64).reshape(-1)
        bounds = self._bounds[job]
        return np.clip(
            np.searchsorted(bounds, ids, side="right") - 1,
            0,
            self.num_shards - 1,
        )

    # ---------------------------------------------------------------- elastic
    def resized(self, num_shards: int) -> "ShardRouter":
        """A new router for the same jobs at a different fleet width.

        Pure construction — the live router is untouched; the caller owns
        the atomic swap.  The epoch increments so both sides of a resize
        are distinguishable even when ``num_shards`` round-trips back.
        """
        return ShardRouter(
            num_shards,
            self._streams_by_job,
            vnodes=self._vnodes,
            epoch=self.epoch + 1,
        )


# ---------------------------------------------------------------------------
# Resize planning: the minimal state movement between two router epochs.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SpanMove:
    """One contiguous global-stream span changing owner.

    ``job`` is multistream; rows ``[lo, hi)`` of its stacked states move
    from shard ``donor`` (old layout) to shard ``recipient`` (new layout).
    For a plain job the whole metric moves and ``lo``/``hi`` are ``-1``.
    """

    job: str
    lo: int
    hi: int
    donor: int
    recipient: int

    @property
    def plain(self) -> bool:
        return self.lo < 0


@dataclass(frozen=True)
class MigrationPlan:
    """Everything that must move to go from ``old`` to ``new`` routing."""

    old_shards: int
    new_shards: int
    moves: Tuple[SpanMove, ...]

    def jobs(self) -> List[str]:
        return sorted({m.job for m in self.moves})

    def rows(self) -> int:
        """Total multistream rows changing owner (plain moves excluded)."""
        return sum(m.hi - m.lo for m in self.moves if not m.plain)


def migration_plan(old: ShardRouter, new: ShardRouter) -> MigrationPlan:
    """The minimal set of :class:`SpanMove` pieces between two routers.

    Multistream jobs: intersect every new-layout span with every old-layout
    span; each non-empty intersection whose owners differ is one contiguous
    piece to move (`shard_spans` keeps spans sorted, so the intersection
    sweep is linear).  Plain jobs: the consistent-hash ring only reassigns
    jobs whose owner actually changed — growing inserts the new shard's
    virtual nodes and steals ~1/N of the keyspace, everything else stays
    put.
    """
    if sorted(old.jobs()) != sorted(new.jobs()):
        raise MetricsTPUUserError(
            "migration_plan needs the same job set on both routers; "
            f"old={old.jobs()} new={new.jobs()}"
        )
    moves: List[SpanMove] = []
    for job in old.jobs():
        if old.is_multistream(job) != new.is_multistream(job):
            raise MetricsTPUUserError(
                f"job {job!r} changed multistream-ness between routers"
            )
        if not old.is_multistream(job):
            d, r = old.owner(job), new.owner(job)
            if d != r:
                moves.append(SpanMove(job, -1, -1, d, r))
            continue
        if old.num_streams(job) != new.num_streams(job):
            raise MetricsTPUUserError(
                f"job {job!r} changed stream width between routers "
                f"({old.num_streams(job)} -> {new.num_streams(job)})"
            )
        for recipient in range(new.num_shards):
            new_lo, new_hi = new.span(job, recipient)
            for donor in range(old.num_shards):
                old_lo, old_hi = old.span(job, donor)
                lo, hi = max(new_lo, old_lo), min(new_hi, old_hi)
                if lo < hi and donor != recipient:
                    moves.append(SpanMove(job, lo, hi, donor, recipient))
    moves.sort(key=lambda m: (m.job, m.lo, m.recipient))
    return MigrationPlan(
        old_shards=old.num_shards,
        new_shards=new.num_shards,
        moves=tuple(moves),
    )
