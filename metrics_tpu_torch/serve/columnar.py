"""Pre-allocated columnar staging between frontend threads and forwarders
(counterpart of ``metrics_tpu/serve/columnar.py``; host numpy only).

The coordinator's ingest path never builds a Python object per record:
request threads copy a batch's scalar columns straight into a
:class:`ColumnRing` — one fixed set of numpy arrays allocated up front —
and the shard's forwarder thread drains **views** of the same storage and
ships them (serialized over HTTP, or copied once at the in-process enqueue
boundary).  One copy in, views out; allocation count is O(1) per ring, not
O(records).

Correctness of the zero-copy hand-off is the two-phase drain: ``drain``
hands out views and marks the rows *pending*; the slots only become
writable again after the forwarder calls ``commit``, so a producer can
never overwrite rows an in-flight forward still references.  Writers and
the single drainer share one short mutex; the drainer's idle wait is a
**timed** condition wait (the lock-order pass checks this module with no
opt-outs).

Backpressure mirrors :class:`~metrics_tpu_torch.serve.ingest.IngestQueue`: a
batch that does not fit is rejected whole (counted in
``serve.records_rejected``) rather than stalling the HTTP thread or
growing without bound.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Deque, List, Optional, Sequence, Tuple

import numpy as np

from metrics_tpu_torch.obs import core as _obs
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

__all__ = ["ColumnRing"]


class ColumnRing:
    """Fixed-capacity columnar ring buffer: many writers, one drainer.

    Args:
        arity: number of value columns (the job metric's positional args).
        capacity: ring rows; also the burst the frontend can absorb while
            the forwarder is busy.
        with_ids: allocate the int32 ``stream_ids`` lane (multistream jobs).
        dtype: dtype of the value columns (scalar rows only — jobs with
            per-row array values take the :class:`Record` path instead).
    """

    def __init__(
        self,
        arity: int,
        capacity: int = 8192,
        with_ids: bool = False,
        dtype: np.dtype = np.float32,
    ) -> None:
        if int(arity) < 1:
            raise MetricsTPUUserError(f"arity must be >= 1, got {arity}")
        if int(capacity) < 1:
            raise MetricsTPUUserError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._cols: List[np.ndarray] = [
            np.empty((self.capacity,), dtype) for _ in range(int(arity))
        ]
        self._ids: Optional[np.ndarray] = (
            np.empty((self.capacity,), np.int32) if with_ids else None
        )
        self._lock = threading.Lock()
        try:  # named in the runtime lock-witness graph
            self._lock.witness_name = "ColumnRing._lock"
        except AttributeError:
            pass
        self._readable = threading.Condition(self._lock)
        self._tail = 0  # first committed-unread slot
        self._count = 0  # buffered rows, pending included
        self._pending = 0  # rows handed to the drainer, not yet committed
        self._hwm = 0  # deepest the ring has ever been (autoscaler signal)
        # WAL frame spans: [seq_or_None, rows] per buffered put batch, in
        # ring order, summing to _count.  Allocated lazily on the first
        # framed put so non-WAL rings pay nothing.
        self._spans: Optional[Deque[List[object]]] = None

    @property
    def arity(self) -> int:
        return len(self._cols)

    def depth(self) -> int:
        with self._lock:
            return self._count

    def pending(self) -> int:
        """Rows handed to the drainer and not yet committed (in flight)."""
        with self._lock:
            return self._pending

    def high_water(self) -> int:
        """Deepest occupancy this ring has ever reached."""
        with self._lock:
            return self._hwm

    # ----------------------------------------------------------------- write
    def put(
        self,
        cols: Sequence[np.ndarray],
        stream_ids: Optional[np.ndarray] = None,
        frame: Optional[
            Callable[[List[np.ndarray], Optional[np.ndarray]], int]
        ] = None,
    ) -> bool:
        """Copy one batch into the ring; ``False`` (counted) when it does
        not fit — backpressure, not blocking.

        ``frame``, when given, is called *under the ring mutex, only after
        the batch is guaranteed accepted*, with the dtype-converted columns
        and ids; it must return the batch's WAL sequence number.  Running
        the WAL append inside the critical section pins ring order == seq
        order (the exactly-once replay invariant) without a second lock,
        and a rejected batch never consumes a seq or touches the log.
        """
        if len(cols) != len(self._cols):
            raise MetricsTPUUserError(
                f"ring holds {len(self._cols)} column(s), got {len(cols)}"
            )
        first = np.asarray(cols[0]).reshape(-1)
        n = int(first.shape[0])
        if (stream_ids is None) != (self._ids is None):
            raise MetricsTPUUserError(
                "stream_ids must be "
                + ("present" if self._ids is not None else "None")
                + " for this ring"
            )
        if n == 0:
            return True
        # convert + validate every lane BEFORE taking the mutex, so a
        # ragged batch cannot leave half-written slots or hold the lock
        # through a raise
        arrs = [np.asarray(c, rc.dtype).reshape(-1) for rc, c in zip(self._cols, cols)]
        if any(a.shape[0] != n for a in arrs):
            raise MetricsTPUUserError(
                f"ragged batch: columns disagree on the row count ({n})"
            )
        ids = None
        if self._ids is not None:
            ids = np.asarray(stream_ids, np.int32).reshape(-1)
            if ids.shape[0] != n:
                raise MetricsTPUUserError(
                    f"ragged batch: {ids.shape[0]} stream_ids for {n} rows"
                )
        if n > self.capacity:
            _obs.counter_inc("serve.records_rejected", n, reason="ring_burst")
            return False
        with self._readable:
            if self.capacity - self._count < n:
                _obs.counter_inc("serve.records_rejected", n, reason="ring_full")
                return False
            head = (self._tail + self._count) % self.capacity
            split = min(n, self.capacity - head)
            for ring_col, arr in zip(self._cols, arrs):
                ring_col[head : head + split] = arr[:split]
                if split < n:
                    ring_col[: n - split] = arr[split:]
            if ids is not None:
                self._ids[head : head + split] = ids[:split]
                if split < n:
                    self._ids[: n - split] = ids[split:]
            if frame is not None:
                if self._spans is None:
                    self._spans = deque()
                    if self._count:
                        # rows staged before WAL mode engaged: unframed
                        self._spans.append([None, self._count])
                seq = int(frame(arrs, ids))
                self._spans.append([seq, n])
            elif self._spans is not None:
                self._spans.append([None, n])
            self._count += n
            if self._count > self._hwm:
                # counter carries the delta so the summed counter IS the
                # fleet-wide high-water mark (autoscaler pressure signal)
                _obs.counter_inc(
                    "serve.ring_occupancy_hwm", self._count - self._hwm
                )
                self._hwm = self._count
            self._readable.notify()
        return True

    # ----------------------------------------------------------------- drain
    def drain(
        self, timeout: float, max_rows: Optional[int] = None
    ) -> Optional[Tuple[List[np.ndarray], Optional[np.ndarray], int]]:
        """Borrow the next contiguous run of rows as views (single drainer).

        Returns ``(col_views, id_view_or_None, n)`` or ``None`` when
        nothing arrives within ``timeout``.  The rows stay reserved until
        :meth:`commit`; exactly one drain may be outstanding at a time.
        Wraparound shows up as two successive drains — views must be
        contiguous to be zero-copy.
        """
        if self._pending:
            raise MetricsTPUUserError(
                "previous drain not committed; call commit(n) first"
            )
        with self._readable:
            if self._count == 0:
                self._readable.wait(timeout)
            avail = self._count
            if avail == 0:
                return None
            run = min(avail, self.capacity - self._tail)
            if max_rows is not None:
                run = min(run, int(max_rows))
            views = [c[self._tail : self._tail + run] for c in self._cols]
            id_view = (
                None
                if self._ids is None
                else self._ids[self._tail : self._tail + run]
            )
            self._pending = run
            return views, id_view, run

    def drain_frames(
        self, timeout: float, max_rows: Optional[int] = None
    ) -> Optional[
        Tuple[
            List[np.ndarray],
            Optional[np.ndarray],
            int,
            List[Tuple[Optional[int], int]],
        ]
    ]:
        """:meth:`drain`, but clipped to whole WAL frames.

        Returns ``(col_views, id_view_or_None, n, spans)`` where ``spans``
        is ``[(seq_or_None, rows), ...]`` partitioning the ``n`` rows into
        the put batches they arrived as — the forwarder ships them so the
        worker can seq-dedup per frame.  On a ring with no framed puts this
        degrades to plain :meth:`drain` with one anonymous span.

        The run never ends mid-frame: shipping half a frame under a seq
        would let a retry double-apply the other half.  When the frame at
        the front straddles the ring's wrap point (so no contiguous view
        can cover it), that one frame is returned as a **copy** — the only
        allocation on this path, bounded to one frame per ring cycle.
        """
        if self._pending:
            raise MetricsTPUUserError(
                "previous drain not committed; call commit(n) first"
            )
        with self._readable:
            if self._count == 0:
                self._readable.wait(timeout)
            avail = self._count
            if avail == 0:
                return None
            run = min(avail, self.capacity - self._tail)
            if max_rows is not None:
                run = min(run, int(max_rows))
            if self._spans is None:
                views = [c[self._tail : self._tail + run] for c in self._cols]
                id_view = (
                    None
                    if self._ids is None
                    else self._ids[self._tail : self._tail + run]
                )
                self._pending = run
                return views, id_view, run, [(None, run)]
            covered, spans = self._span_prefix(run)
            if covered:
                views = [c[self._tail : self._tail + covered] for c in self._cols]
                id_view = (
                    None
                    if self._ids is None
                    else self._ids[self._tail : self._tail + covered]
                )
                self._pending = covered
                return views, id_view, covered, spans
            # the front frame is wider than the contiguous window (wrap) or
            # the max_rows clip: hand out exactly that frame, copying the
            # two arcs together when it wraps
            seq, rows = self._spans[0]
            rows = int(rows)
            views = [self._arc(c, rows) for c in self._cols]
            id_view = None if self._ids is None else self._arc(self._ids, rows)
            self._pending = rows
            return views, id_view, rows, [(seq, rows)]  # type: ignore[list-item]

    def _arc(self, col: np.ndarray, rows: int) -> np.ndarray:
        first = min(rows, self.capacity - self._tail)
        if first >= rows:
            return col[self._tail : self._tail + rows]
        return np.concatenate([col[self._tail :], col[: rows - first]])

    def _span_prefix(
        self, limit: int
    ) -> Tuple[int, List[Tuple[Optional[int], int]]]:
        covered = 0
        out: List[Tuple[Optional[int], int]] = []
        for seq, rows in self._spans:  # type: ignore[union-attr]
            if covered + int(rows) > limit:  # type: ignore[arg-type]
                break
            out.append((seq, int(rows)))  # type: ignore[arg-type]
            covered += int(rows)  # type: ignore[arg-type]
        return covered, out

    def commit(self, n: int) -> None:
        """Release the first ``n`` rows of the outstanding drain: their
        slots become writable and the views returned for them go stale."""
        n = int(n)
        with self._lock:
            if n < 0 or n > self._pending:
                raise MetricsTPUUserError(
                    f"commit({n}) does not match the outstanding drain "
                    f"({self._pending} row(s))"
                )
            if n < self._pending:
                # the park lane: drained rows NOT released stay buffered and
                # will be re-drained later (forward failure, held job,
                # split-owner prefix) — commit(0) parks the whole drain
                _obs.counter_inc("serve.parked_rows", self._pending - n)
            if self._spans is not None and n:
                remaining = n
                while remaining and self._spans:
                    span = self._spans[0]
                    rows = int(span[1])  # type: ignore[arg-type]
                    if rows <= remaining:
                        remaining -= rows
                        self._spans.popleft()
                        continue
                    # a commit inside a frame (split-owner prefix, mid-
                    # resize): the surviving remainder can no longer replay
                    # exactly-once as a frame, so it is demoted to unframed
                    # rows — the documented resize/WAL overlap caveat
                    span[1] = rows - remaining
                    if span[0] is not None:
                        span[0] = None
                        _obs.counter_inc("serve.wal_unframed_rows", rows - remaining)
                    remaining = 0
            self._tail = (self._tail + n) % self.capacity
            self._count -= n
            self._pending = 0
