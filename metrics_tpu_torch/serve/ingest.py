"""Ingestion pipeline: bounded record queue -> fixed-shape blocks (counterpart
of ``metrics_tpu/serve/ingest.py``).

Producers call :meth:`IngestQueue.put` with one :class:`Record` per input
row; the single consumer thread (driven by the server) drains the queue and
micro-batches rows per job into **fixed-shape dispatches**:

* **Multistream jobs** fill fixed-capacity padded blocks: rows stack into a
  ``(block_rows, ...)`` block, short blocks pad with zero rows whose
  ``stream_id`` is ``-1`` and a ``num_valid`` row count — pad rows neither
  route on device nor count into the metric's ``dropped_rows`` signal, so
  padding provably never touches metric state *or* its drop accounting.
* **Plain jobs** (no stream routing, so no drop lane to pad into) decompose
  each flush into power-of-two chunks capped at ``block_rows``, and every
  row is dispatched exactly once — bit-identical to calling ``update``
  directly with the same chunks.

The JAX package picks these shapes so its jitted updates never retrace.
The port compiles nothing, but it keeps the same pieces: a float state sums
each piece's rows as one reduction, so other pieces would add in another
order, and a job's state would no longer equal the JAX package's, or that
of a metric updated directly with the same pieces.

Each flush uploads its rows to the job metric's device once per column
(one host-to-device copy each) and slices the pieces there.
* **Residual-row carry**: a non-forced flush dispatches only whole blocks
  and carries the sub-block tail to the next flush, so steady-state
  traffic never pays the pow2 tail dispatches; the consumer forces a tail
  out only once it has waited a full ``flush_interval``.

Rows arrive either as one :class:`Record` per queue item or as a
:class:`ColumnBatch` — pre-stacked column arrays the sharded frontend
forwards as views, one queue slot per batch.

Back-pressure is the queue bound: a full queue rejects the record (counted
in ``serve.records_rejected``) instead of stalling the producer or growing
without limit.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.obs import core as _obs
from metrics_tpu_torch.serve.registry import EvalJob, MetricRegistry
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

__all__ = ["Record", "ColumnBatch", "IngestQueue", "BlockBatcher", "IngestConsumer"]


class Record(NamedTuple):
    """One input row for one job.

    ``values`` are the job metric's positional update arguments for a single
    row (scalars or fixed-shape per-row arrays — every record of a job must
    agree on shapes, the static-shape contract).  ``stream_id`` routes the
    row on multistream jobs and must be ``None`` on plain jobs.
    """

    job: str
    values: Tuple[Any, ...]
    stream_id: Optional[int] = None


class ColumnBatch(NamedTuple):
    """Many rows for one job, already columnar.

    The sharded frontend stages ingest into pre-allocated column arrays and
    forwards contiguous views — one queue item per batch instead of one
    Python object per record.  ``cols`` holds one ``(n, ...)`` array per
    update argument; ``stream_ids`` is an ``(n,)`` int32 array on
    multistream jobs and ``None`` on plain jobs.

    ``seq`` is the batch's WAL frame sequence number when durable ingest
    is on (``metrics_tpu_torch.serve.wal``): the consumer advances its per-job
    applied-seq watermark after folding the batch, and checkpoints persist
    those watermarks so failover replays exactly the frames past them.
    """

    job: str
    cols: Tuple[np.ndarray, ...]
    stream_ids: Optional[np.ndarray] = None
    seq: Optional[int] = None


class _FlushToken:
    """Sentinel a producer enqueues to observe a drain point: the consumer
    flushes every batcher, then sets the event.

    A **hold** token additionally freezes the consumer at the drain point:
    after flushing, the consumer snapshots its WAL watermarks into
    ``marks``, signals ``done``, and then waits (bounded) on ``release``
    before applying anything else.  Checkpoints use this so the saved
    watermarks are *exactly* the state the snapshot contains — without the
    hold, a frame applied between flush and encode would be inside the
    snapshot but past the recorded watermark, and replay would double-apply
    it.  Plain (non-hold) tokens behave exactly as before.
    """

    _HOLD_TIMEOUT = 60.0  # release is belt-and-braces bounded: a crashed
    # checkpointer must not wedge the consumer forever

    def __init__(self, hold: bool = False) -> None:
        self.done = threading.Event()
        self.hold = bool(hold)
        self.release = threading.Event()
        self.marks: Dict[str, int] = {}


class IngestQueue:
    """Bounded MPSC record queue with rejection accounting."""

    def __init__(self, capacity: int = 4096) -> None:
        if int(capacity) < 1:
            raise MetricsTPUUserError(f"queue capacity must be >= 1, got {capacity}")
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=int(capacity))
        self.capacity = int(capacity)

    def put(
        self, record: Union[Record, ColumnBatch], timeout: Optional[float] = None
    ) -> bool:
        """Enqueue one record (or one columnar batch — a batch costs one
        queue slot no matter how many rows it carries); ``False`` (and a
        counter tick) when the queue is full past ``timeout`` — bounded
        memory beats unbounded lag."""
        try:
            if timeout is None:
                self._q.put_nowait(record)
            else:
                self._q.put(record, timeout=timeout)
            return True
        except queue.Full:
            _obs.counter_inc("serve.records_rejected")
            return False

    def put_control(self, token: _FlushToken, timeout: Optional[float] = None) -> bool:
        """Enqueue a control token (flush sentinel).  Untimed by default —
        tokens are rare and the caller is waiting on the round-trip anyway —
        but callers that must re-check consumer liveness (a dead writer
        never drains a full queue) pass ``timeout`` and retry on ``False``."""
        try:
            if timeout is None:
                self._q.put(token)
            else:
                self._q.put(token, timeout=timeout)
        except queue.Full:
            return False
        return True

    def get(self, timeout: float) -> Any:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def depth(self) -> int:
        return self._q.qsize()


def _upload(col: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host column as a tensor on ``device``: one copy to the card (none on
    the CPU).  A read-only buffer (a request body, a decoded WAL frame) is
    copied once first, as ``torch.from_numpy`` needs a writable array."""
    col = np.ascontiguousarray(col)
    if not col.flags.writeable:
        col = col.copy()
    return torch.from_numpy(col).to(device)


def _pow2_chunks(n: int, cap: int) -> List[int]:
    """Greedy power-of-two decomposition of ``n``, capped at ``cap`` — the
    fixed shape-set plain jobs dispatch in."""
    out: List[int] = []
    while n >= cap:
        out.append(cap)
        n -= cap
    size = cap >> 1
    while n > 0 and size > 0:
        if n >= size:
            out.append(size)
            n -= size
        size >>= 1
    return out


class BlockBatcher:
    """Per-job row accumulator that emits static-shape ``update`` dispatches.

    Buffered rows live as columnar *segments* (one per staged row-batch or
    :class:`ColumnBatch`).  A **forced** flush dispatches everything —
    full blocks, then the pow2 tail (plain) or one padded block
    (multistream) — bit-identical to dispatching the rows directly.  A
    **non-forced** flush dispatches only whole ``block_rows`` blocks and
    *carries* the residue, so steady-state traffic costs exactly one
    full-block dispatch per ``block_rows`` rows instead of up to
    ``log2(block_rows)+1`` tail dispatches per flush.  ``age`` lets the
    consumer force a flush only when the carried rows have actually gone
    stale, preserving the ingest-to-state latency bound.
    """

    def __init__(self, job: EvalJob, block_rows: int = 256) -> None:
        if int(block_rows) < 1:
            raise MetricsTPUUserError(f"block_rows must be >= 1, got {block_rows}")
        # power-of-two capacity keeps the plain-job chunk set nested
        b = int(block_rows)
        if b & (b - 1):
            raise MetricsTPUUserError(
                f"block_rows must be a power of two, got {block_rows}"
            )
        self.job = job
        self.block_rows = b
        self._rows: List[Tuple[Any, ...]] = []
        self._ids: List[int] = []
        # carried columnar segments: (cols, ids-or-None, n) in arrival order
        self._segments: List[Tuple[List[np.ndarray], Optional[np.ndarray], int]] = []
        self._segments_n = 0
        self._oldest: Optional[float] = None  # monotonic enqueue time, oldest row
        self.rows_padded = 0  # host counter: pad rows ever dispatched

    def __len__(self) -> int:
        return self._segments_n + len(self._rows)

    def age(self, now: Optional[float] = None) -> float:
        """Seconds the oldest buffered row has waited (0.0 when empty)."""
        if self._oldest is None:
            return 0.0
        return (time.monotonic() if now is None else now) - self._oldest

    def add(self, record: Record) -> None:
        if self.job.is_multistream:
            if record.stream_id is None:
                raise MetricsTPUUserError(
                    f"job {self.job.name!r} is multistream; records need a stream_id"
                )
            self._ids.append(int(record.stream_id))
        elif record.stream_id is not None:
            raise MetricsTPUUserError(
                f"job {self.job.name!r} is {self.job.kind}; stream_id must be None"
            )
        self._rows.append(record.values)
        if self._oldest is None:
            self._oldest = time.monotonic()
        if len(self) >= self.block_rows:
            # a full block dispatches as-is; force would add nothing
            self.flush(force=False)

    def extend_columns(
        self, cols: Sequence[np.ndarray], stream_ids: Optional[np.ndarray] = None
    ) -> int:
        """Buffer ``n`` already-columnar rows without per-record objects.

        ``cols`` are views or arrays with a shared leading dim ``n``; they
        are staged as one segment (no copy) and dispatched on the next
        block boundary.  Returns ``n``.
        """
        if self.job.is_multistream:
            if stream_ids is None:
                raise MetricsTPUUserError(
                    f"job {self.job.name!r} is multistream; batches need stream_ids"
                )
        elif stream_ids is not None:
            raise MetricsTPUUserError(
                f"job {self.job.name!r} is {self.job.kind}; stream_ids must be None"
            )
        cols = [np.asarray(c) for c in cols]
        if not cols:
            raise MetricsTPUUserError("ColumnBatch needs at least one column")
        n = int(cols[0].shape[0]) if cols[0].ndim else -1
        if n < 0 or any(c.ndim == 0 or c.shape[0] != n for c in cols):
            raise MetricsTPUUserError(
                f"job {self.job.name!r}: columns must share one leading dim"
            )
        ids = None
        if stream_ids is not None:
            ids = np.asarray(stream_ids, np.int32).reshape(-1)
            if ids.shape[0] != n:
                raise MetricsTPUUserError(
                    f"job {self.job.name!r}: stream_ids length {ids.shape[0]} != {n}"
                )
        if n == 0:
            return 0
        self._stage_rows()  # keep arrival order when add() rows are pending
        self._segments.append((cols, ids, n))
        self._segments_n += n
        if self._oldest is None:
            self._oldest = time.monotonic()
        if len(self) >= self.block_rows:
            self.flush(force=False)
        return n

    # ------------------------------------------------------------- dispatch
    def _stack(self, rows: Sequence[Tuple[Any, ...]]) -> List[np.ndarray]:
        arity = len(rows[0])
        if any(len(r) != arity for r in rows):
            raise MetricsTPUUserError(
                f"job {self.job.name!r} received records of mixed arity"
            )
        return [np.stack([np.asarray(r[i]) for r in rows]) for i in range(arity)]

    def _stage_rows(self) -> None:
        """Move the row-major add() buffer into one columnar segment.  The
        rows are consumed before stacking so a malformed batch is dropped
        (and counted by the caller), never retried forever."""
        rows, self._rows = self._rows, []
        ids, self._ids = self._ids, []
        if not rows:
            return
        cols = self._stack(rows)
        seg_ids = np.asarray(ids, np.int32) if self.job.is_multistream else None
        self._segments.append((cols, seg_ids, len(rows)))
        self._segments_n += len(rows)

    def _take(self, count: int) -> Tuple[List[np.ndarray], Optional[np.ndarray]]:
        """Pop the first ``count`` buffered rows as one columnar batch.
        Whole segments pass through as views; a straddling segment is split
        by slicing (still views) — at most one concatenate per flush."""
        parts: List[Tuple[List[np.ndarray], Optional[np.ndarray]]] = []
        got = 0
        while got < count:
            cols, ids, n = self._segments[0]
            take = min(n, count - got)
            if take == n:
                self._segments.pop(0)
                parts.append((cols, ids))
            else:
                parts.append(
                    ([c[:take] for c in cols], None if ids is None else ids[:take])
                )
                self._segments[0] = (
                    [c[take:] for c in cols],
                    None if ids is None else ids[take:],
                    n - take,
                )
            got += take
        self._segments_n -= count
        if not self._segments:
            self._oldest = None
        if len(parts) == 1:
            return parts[0]
        arity = len(parts[0][0])
        if any(len(p[0]) != arity for p in parts):
            raise MetricsTPUUserError(
                f"job {self.job.name!r} received records of mixed arity"
            )
        cols = [np.concatenate([p[0][i] for p in parts]) for i in range(arity)]
        ids = (
            None
            if parts[0][1] is None
            else np.concatenate([p[1] for p in parts])
        )
        return cols, ids

    def flush(self, force: bool = True) -> int:
        """Dispatch buffered rows; returns the number of rows sent.

        ``force=True`` (the default — what flush tokens, drains and
        checkpoints use) sends everything, tail included.  ``force=False``
        sends only whole blocks and carries the residue for the next flush.
        """
        if self._rows:
            self._stage_rows()
        n = self._segments_n
        if not n:
            return 0
        send = n if force else (n // self.block_rows) * self.block_rows
        if not send:
            return 0
        host_cols, host_ids = self._take(send)
        with self.job.lock:
            device = self.job.metric.device
            cols = [_upload(c, device) for c in host_cols]
            if self.job.is_multistream:
                ids = _upload(host_ids, device)
                start = 0
                while start < send:
                    m = min(self.block_rows, send - start)
                    block = [c[start : start + m] for c in cols]
                    pad = self.block_rows - m
                    id_col = ids[start : start + m]
                    if pad:
                        block = [
                            torch.cat([c, c.new_zeros((pad,) + tuple(c.shape[1:]))])
                            for c in block
                        ]
                        # -1 is out of [0, num_streams): the scatter drops the
                        # pad rows, so short blocks stay bit-exact; num_valid
                        # keeps them out of the dropped_rows accounting too
                        id_col = torch.cat([id_col, id_col.new_full((pad,), -1)])
                    self.job.metric.update(
                        *block,
                        stream_ids=id_col,
                        num_valid=torch.tensor([m], dtype=torch.int32, device=device),
                    )
                    self.rows_padded += pad
                    if pad:
                        _obs.counter_inc("serve.rows_padded", pad)
                    self.job.blocks_dispatched += 1
                    _obs.counter_inc("serve.blocks_dispatched", job=self.job.name)
                    start += m
            else:
                start = 0
                for size in _pow2_chunks(send, self.block_rows):
                    self.job.metric.update(*[c[start : start + size] for c in cols])
                    start += size
                    self.job.blocks_dispatched += 1
                    _obs.counter_inc("serve.blocks_dispatched", job=self.job.name)
            self.job.records_ingested += send
        _obs.counter_inc("serve.records_ingested", send)
        return send


class IngestConsumer:
    """The single consumer thread: queue -> batchers -> fixed-shape blocks.

    ``flush_interval`` bounds ingest-to-state latency: a partial block older
    than this flushes even though it is not full.  ``run`` exits when
    ``stop`` is set AND the queue has drained (graceful) or immediately on
    ``kill`` (preemption drill).

    Untrusted rows cannot kill the writer: anything a record raises while
    batching or dispatching (bad dtypes, ragged nested shapes, a stream_id
    that is not an int, ...) is counted, logged, and dropped — the offending
    record (or at worst its buffered batch) is lost, the thread and every
    other job keep going.  A writer that dies anyway (a bug, not bad input)
    is surfaced through ``EvalServer.health()``'s ``consumer_alive``.
    """

    _MAX_ERRORS = 100  # keep the first N messages; count the rest

    def __init__(
        self,
        registry: MetricRegistry,
        ingest_queue: IngestQueue,
        block_rows: int = 256,
        flush_interval: float = 0.05,
        poll_timeout: float = 0.02,
    ) -> None:
        self.registry = registry
        self.queue = ingest_queue
        self.block_rows = int(block_rows)
        self.flush_interval = float(flush_interval)
        self.poll_timeout = float(poll_timeout)
        self.batchers: Dict[str, BlockBatcher] = {
            job.name: BlockBatcher(job, block_rows=block_rows) for job in registry.jobs()
        }
        self.stop = threading.Event()  # graceful: drain, then exit
        self.kill = threading.Event()  # preemption: exit now, drop the queue
        self.errors: List[str] = []
        self.errors_total = 0
        # per-job applied-seq watermarks (WAL mode): the highest frame seq
        # whose rows this consumer has folded (or deterministically
        # dropped).  Only this thread writes after seeding; checkpoint
        # hold-tokens snapshot it at a quiesced drain point.
        self.wal_marks: Dict[str, int] = {}

    def record_error(self, message: str) -> None:
        """Append to the bounded error log (a malformed-record flood must
        not grow host memory without limit in a long-running service)."""
        self.errors_total += 1
        if len(self.errors) < self._MAX_ERRORS:
            self.errors.append(message)

    def flush_all(self, stale_after: Optional[float] = None) -> int:
        """Flush every batcher.  A batch that fails to dispatch is dropped
        and counted — it must not wedge the writer or starve other jobs.

        ``stale_after=None`` (tokens, drains, checkpoints) forces every
        tail out.  With a threshold (the interval flush), a batcher only
        forces its sub-block tail once its oldest row has waited that
        long; younger residues carry forward so steady-state traffic
        dispatches full blocks only.
        """
        total = 0
        now = time.monotonic() if stale_after is not None else 0.0
        for batcher in self.batchers.values():
            force = stale_after is None or batcher.age(now) >= stale_after
            try:
                total += batcher.flush(force=force)
            except Exception as err:  # noqa: BLE001 — untrusted rows reach np.stack/update
                _obs.counter_inc("serve.flush_failures", job=batcher.job.name)
                self.record_error(
                    f"flush of job {batcher.job.name!r} dropped a batch: "
                    f"{type(err).__name__}: {err}"
                )
        return total

    def _batcher_for(self, name: str) -> Optional[BlockBatcher]:
        batcher = self.batchers.get(name)
        if name not in self.registry:
            if batcher is not None:
                # the job was retired (elastic resize moved it away): drop
                # the inert batcher — only this (consumer) thread ever
                # mutates the map — so rows stop folding into dead state
                del self.batchers[name]
            return None
        job = self.registry[name]
        if batcher is None or batcher.job is not job:
            # a job registered after the consumer came up (or re-registered
            # with a fresh EvalJob by a migration commit) still routes
            batcher = self.batchers[name] = BlockBatcher(
                job, block_rows=self.block_rows
            )
        return batcher

    def _consume(self, item: Any, last_flush: float, now: float) -> float:
        if isinstance(item, _FlushToken):
            self.flush_all()
            if item.hold:
                # quiesce for a watermark-exact checkpoint: the marks
                # captured here describe precisely the rows the flush just
                # folded, and nothing further folds until the checkpointer
                # finishes encoding and releases us (bounded wait — see
                # _FlushToken)
                item.marks = dict(self.wal_marks)
                item.done.set()
                item.release.wait(_FlushToken._HOLD_TIMEOUT)
            else:
                item.done.set()
            return now
        try:
            batcher = self._batcher_for(item.job)
            if batcher is None:
                _obs.counter_inc("serve.records_unroutable")
                self.record_error(f"unknown job {item.job!r}")
                return last_flush
            if isinstance(item, ColumnBatch):
                batcher.extend_columns(item.cols, item.stream_ids)
            else:
                batcher.add(item)
        except MetricsTPUUserError as err:
            _obs.counter_inc("serve.records_malformed")
            self.record_error(str(err))
        except Exception as err:  # noqa: BLE001 — POST /ingest data is untrusted
            _obs.counter_inc("serve.records_malformed")
            self.record_error(f"{type(err).__name__}: {err}")
        finally:
            # the watermark advances even when the batch was dropped
            # (malformed / retired job): a replay of the same frame would
            # drop it identically, so "applied" means "its effect — possibly
            # nothing — is in this state", keeping replay exactly-once and
            # segment truncation unwedged
            seq = getattr(item, "seq", None)
            if seq is not None:
                job = getattr(item, "job", None)
                if job is not None and seq > self.wal_marks.get(job, -1):
                    self.wal_marks[job] = int(seq)
        return last_flush

    def run(self) -> None:
        import time as _time

        last_flush = _time.monotonic()
        while not self.kill.is_set():
            item = self.queue.get(timeout=self.poll_timeout)
            now = _time.monotonic()
            if item is not None:
                last_flush = self._consume(item, last_flush, now)
            elif self.stop.is_set():
                break  # queue drained after stop: graceful exit
            # the latency bound applies under steady trickle too, not just
            # when the queue goes idle; a tail younger than the interval is
            # carried (full-block dispatches only), so the worst-case
            # ingest-to-state latency is ~2x flush_interval
            if now - last_flush >= self.flush_interval:
                if self.flush_all(stale_after=self.flush_interval):
                    _obs.counter_inc("serve.interval_flushes")
                last_flush = now
        if not self.kill.is_set():
            self.flush_all()
