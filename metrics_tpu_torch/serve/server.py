"""EvalServer: the long-running process tying the serve pieces together
(counterpart of ``metrics_tpu/serve/server.py``).

Thread layout (one process, no new dependencies):

* **consumer** — the single writer; drains the :class:`IngestQueue` into
  per-job :class:`BlockBatcher` dispatches (see ``ingest.py``).  On the card
  it queues each block's kernels on the device's current stream.
* **http** — a pooled HTTP server answering ``/healthz``, ``/metrics``,
  ``/query`` and ``POST /ingest``; read paths take per-job locks only.  A
  read queues its work on the same stream as the consumer (neither thread
  sets a stream of its own), so under the job lock it sees every block the
  consumer queued before it.
* **durability** (optional) — polls :meth:`CheckpointManager.save_due` and
  snapshots the whole registry when the max-staleness budget runs out or an
  operator armed :meth:`~CheckpointManager.request_save`.

Lifecycle:

* :meth:`start` restores from the newest committed checkpoint when one
  exists (restore-on-start), then brings the threads up.
* :meth:`stop` is the graceful path: mark draining (``/healthz`` flips to
  503, new records are rejected), let the consumer drain the queue and
  flush every partial block, take one final checkpoint, then shut the HTTP
  server down.  A drained-and-stopped server loses nothing.
* :meth:`kill` is the preemption drill: drop the queue and stop without a
  final checkpoint — restart recovery is the durability loop's last commit.
"""
# analyze: skip-file[serve-blocking] -- this module IS the durability layer:
# it owns the checkpoint imports and the save/restore calls that the
# request-path modules (httpd/ingest/registry/traffic) are banned from making.

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from metrics_tpu_torch.checkpoint.manager import (
    CheckpointManager,
    apply_metric_transfer,
    decode_stream_span,
    encode_metric_transfer,
    encode_stream_span,
)
from metrics_tpu_torch.multistream import MultiStreamMetric
from metrics_tpu_torch.obs import core as _obs
from metrics_tpu_torch.serve.httpd import make_http_server
from metrics_tpu_torch.serve.ingest import (
    ColumnBatch,
    IngestConsumer,
    IngestQueue,
    Record,
    _FlushToken,
)
from metrics_tpu_torch.serve.registry import MetricRegistry
from metrics_tpu_torch.utils.exceptions import CheckpointError, MetricsTPUUserError

__all__ = ["ServeConfig", "EvalServer"]


@dataclass
class ServeConfig:
    """Knobs for one :class:`EvalServer`.

    ``port=0`` binds an ephemeral port (read it back from
    :attr:`EvalServer.port` — what the tests and the bench do).
    ``flush_interval`` bounds ingest-to-state latency for partial blocks;
    ``durability_poll`` bounds how stale past ``max_staleness`` a crash can
    strand you, so keep it well under the manager's budget.

    ``wal_exactly_once`` is set by the fleet when durable (WAL-backed)
    ingest is on: checkpoints then quiesce the consumer at the flush point
    (a *hold* token) so the per-job applied-seq watermarks they persist
    describe exactly the snapshot's contents, and ``health()`` exposes the
    live watermarks for failover replay.
    """

    host: str = "127.0.0.1"
    port: int = 0
    queue_capacity: int = 4096
    block_rows: int = 256
    flush_interval: float = 0.05
    poll_timeout: float = 0.02
    drain_timeout: float = 30.0
    durability_poll: float = 0.1
    wal_exactly_once: bool = False


def _determined(extra: Dict[str, Any]) -> Dict[str, Any]:
    """``extra`` without the attributes a metric has not determined yet (None)."""
    out: Dict[str, Any] = {}
    for key, value in extra.items():
        if isinstance(value, dict) and "__enum__" not in value:
            value = _determined(value)
        if value is not None and value != {}:
            out[key] = value
    return out


class EvalServer:
    """One registry + one queue + the three service threads."""

    def __init__(
        self,
        registry: MetricRegistry,
        config: Optional[ServeConfig] = None,
        checkpoint_manager: Optional[CheckpointManager] = None,
        builders: Optional[Dict[str, Any]] = None,
    ) -> None:
        if len(registry) == 0:
            raise MetricsTPUUserError("EvalServer needs at least one registered job")
        self.registry = registry
        self.config = config or ServeConfig()
        self.manager = checkpoint_manager
        # job name -> JobSpec-like (.build/.components/.export_top_k): how to
        # construct a fresh metric when an elastic resize migrates a span in
        self._builders: Dict[str, Any] = dict(builders or {})
        self._staged: Dict[str, Any] = {}  # job -> post-resize metric, uncommitted
        self._migrate_lock = threading.Lock()
        try:
            self._migrate_lock.witness_name = "EvalServer._migrate_lock"
        except AttributeError:
            pass
        self.queue = IngestQueue(capacity=self.config.queue_capacity)
        self.consumer = IngestConsumer(
            registry,
            self.queue,
            block_rows=self.config.block_rows,
            flush_interval=self.config.flush_interval,
            poll_timeout=self.config.poll_timeout,
        )
        self.last_checkpoint_step: Optional[int] = None
        self.restored_step: Optional[int] = None
        # WAL seq-dedup floor: highest frame seq ENQUEUED per job (the
        # consumer's wal_marks track the applied floor).  A forward retry
        # or failover replay carrying seq <= this floor is dropped as an
        # idempotent success — the exactly-once half the frontend's
        # durable ack relies on.
        self._wal_enqueued: Dict[str, int] = {}
        self._wal_lock = threading.Lock()
        try:
            self._wal_lock.witness_name = "EvalServer._wal_lock"
        except AttributeError:
            pass
        # watermarks the last committed checkpoint recorded (segment
        # truncation reads these: frames at or below them can never replay)
        self.last_checkpoint_wal_marks: Optional[Dict[str, int]] = None
        self._httpd = None
        self._threads: Dict[str, threading.Thread] = {}
        self._durability_stop = threading.Event()
        self._draining = False
        self._started = False
        self._stopped = False
        self._t0 = time.monotonic()
        self._ckpt_lock = threading.Lock()  # serializes checkpoint_now callers
        try:  # named in the runtime lock-witness graph; raw Locks reject attrs
            self._ckpt_lock.witness_name = "EvalServer._ckpt_lock"
        except AttributeError:
            pass

    # ---------------------------------------------------------------- startup
    def start(self) -> "EvalServer":
        """Restore-on-start, then bring up consumer + HTTP (+ durability)."""
        if self._started:
            raise MetricsTPUUserError("EvalServer.start() called twice")
        self._started = True
        self._t0 = time.monotonic()
        if self.manager is not None and self.manager.latest_step() is not None:
            # build the target OUTSIDE the sweep: its one-time construction
            # takes the same sorted job locks, and nesting that inside
            # locked() would witness reversed acquisition edges
            target = self.registry.checkpoint_target()
            with self.registry.locked():
                result = self.manager.restore(target)
            self.restored_step = self.last_checkpoint_step = result.step
            marks = (result.extra or {}).get("wal_marks")
            if marks:
                # seed both dedup floors BEFORE any thread starts: frames at
                # or below these seqs are inside the restored state, so a
                # replay (or late retry) of them must land as a no-op
                marks = {str(j): int(s) for j, s in marks.items()}
                self.consumer.wal_marks.update(marks)
                self._wal_enqueued.update(marks)
                self.last_checkpoint_wal_marks = dict(marks)
            _obs.counter_inc("serve.restores")
        self._spawn("consumer", self.consumer.run)
        self._httpd = make_http_server(self.config.host, self.config.port, self)
        # a 0.1s shutdown-poll keeps stop()/kill() teardown snappy
        self._spawn("http", lambda: self._httpd.serve_forever(poll_interval=0.1))
        if self.manager is not None:
            self._spawn("durability", self._durability_loop)
        return self

    def _spawn(self, name: str, fn: Any) -> None:
        t = threading.Thread(target=fn, name=f"serve-{name}", daemon=True)
        self._threads[name] = t
        t.start()

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise MetricsTPUUserError("server is not started")
        return self._httpd.server_address[1]

    @property
    def address(self) -> Tuple[str, int]:
        if self._httpd is None:
            raise MetricsTPUUserError("server is not started")
        return (self.config.host, self.port)

    # ---------------------------------------------------------------- ingest
    def submit(
        self,
        job: str,
        values: Tuple[Any, ...],
        stream_id: Optional[int] = None,
        timeout: Optional[float] = None,
    ) -> bool:
        """Enqueue one record; ``False`` when draining or the queue is full."""
        if self._draining:
            _obs.counter_inc("serve.records_rejected", reason="draining")
            return False
        return self.queue.put(Record(job, tuple(values), stream_id), timeout=timeout)

    def submit_columns(
        self,
        job: str,
        cols: Tuple[Any, ...],
        stream_ids: Optional[Any] = None,
        timeout: Optional[float] = None,
        seqs: Optional[Any] = None,
    ) -> bool:
        """Enqueue many rows as ONE columnar batch (one queue slot).

        ``cols`` are pre-stacked ``(n, ...)`` arrays — the zero-copy path
        the sharded frontend forwards ring views through; the consumer
        carries them straight into block dispatches without ever
        materializing per-record Python objects.

        ``seqs`` — ``[(seq_or_None, rows), ...]`` partitioning the rows
        into WAL frames — turns the call idempotent: each framed slice
        whose seq is at or below this worker's enqueue floor is dropped as
        an already-landed duplicate (a forward retry or a failover replay),
        everything else enqueues one :class:`ColumnBatch` per frame and
        advances the floor.  Returns ``True`` only when every frame either
        enqueued or deduped — a partial enqueue reports ``False`` so the
        sender parks and retries the whole ship, and the floor makes that
        retry exactly-once.
        """
        if self._draining:
            _obs.counter_inc("serve.records_rejected", reason="draining")
            return False
        if seqs is None:
            return self.queue.put(
                ColumnBatch(job, tuple(cols), stream_ids), timeout=timeout
            )
        cols = tuple(cols)
        total = int(len(cols[0])) if cols else 0
        if sum(int(n) for _, n in seqs) != total:
            raise MetricsTPUUserError(
                f"seqs cover {sum(int(n) for _, n in seqs)} row(s) but the "
                f"batch has {total}"
            )
        off = 0
        with self._wal_lock:
            for seq, n in seqs:
                n = int(n)
                part = tuple(c[off : off + n] for c in cols)
                part_ids = (
                    None if stream_ids is None else stream_ids[off : off + n]
                )
                off += n
                if seq is not None:
                    seq = int(seq)
                    if seq <= self._wal_enqueued.get(job, -1):
                        _obs.counter_inc("serve.wal_deduped_frames")
                        _obs.counter_inc("serve.wal_deduped_rows", n)
                        continue
                if not self.queue.put(
                    ColumnBatch(job, part, part_ids, seq), timeout=timeout
                ):
                    return False
                if seq is not None:
                    self._wal_enqueued[job] = seq
        return True

    def flush(self, timeout: float = 10.0) -> bool:
        """Force every partial block into metric state and wait for it.

        Round-trips a token through the queue while the consumer is alive
        (so it serializes after everything already enqueued); falls back to
        a direct flush once the consumer has exited.  Every wait is timed
        and liveness is re-checked between them: a writer that dies with the
        queue full makes this return ``False`` within ``timeout`` instead of
        blocking forever on an enqueue nothing will ever drain.
        """
        deadline = time.monotonic() + float(timeout)
        token = _FlushToken()
        consumer = self._threads.get("consumer")
        while consumer is not None and consumer.is_alive():
            remaining = deadline - time.monotonic()
            if remaining <= 0.0:
                return False
            if self.queue.put_control(token, timeout=min(0.5, remaining)):
                return token.done.wait(max(0.0, deadline - time.monotonic()))
        # the single writer has exited: flushing inline cannot race it
        self.consumer.flush_all()
        return True

    def _hold_flush(self, timeout: float = 10.0) -> Optional[_FlushToken]:
        """:meth:`flush`, but freeze the consumer at the drain point.

        Returns the completed hold token — its ``marks`` are the WAL
        watermarks of exactly the state now folded in, and the consumer
        stays parked until the caller sets ``token.release`` — or ``None``
        on timeout.  The caller MUST release the token on every path.
        """
        deadline = time.monotonic() + float(timeout)
        token = _FlushToken(hold=True)
        consumer = self._threads.get("consumer")
        while consumer is not None and consumer.is_alive():
            remaining = deadline - time.monotonic()
            if remaining <= 0.0:
                return None
            if self.queue.put_control(token, timeout=min(0.5, remaining)):
                if token.done.wait(max(0.0, deadline - time.monotonic())):
                    return token
                # pre-release the abandoned token so the consumer, when it
                # eventually reaches it, does not park for a caller that gave up
                token.release.set()
                return None
        # the single writer has exited: nothing can race the encode, so an
        # inline flush plus a direct mark snapshot is already quiesced
        self.consumer.flush_all()
        token.marks = dict(self.consumer.wal_marks)
        token.done.set()
        return token

    # ------------------------------------------------------------ durability
    def checkpoint_now(self, step: Optional[int] = None) -> int:
        """Flush, encode each job under its own lock, commit lock-free.

        The encode holds one brief per-job lock per metric (never the
        registry-wide sweep) and the store writes + commit barrier run with
        NO job lock held, so ``/query`` latency stays flat while a snapshot
        is in flight.  The snapshot is per-job-consistent: each job's state
        is internally coherent, but two jobs may be captured a few records
        apart — the consistency restore actually needs, since every metric
        restores independently.
        """
        if self.manager is None:
            raise MetricsTPUUserError("EvalServer has no CheckpointManager")
        with self._ckpt_lock:
            hold: Optional[_FlushToken] = None
            marks: Optional[Dict[str, int]] = None
            if self.config.wal_exactly_once:
                # hold-flush: the consumer parks between the flush and our
                # release, so the watermarks below describe EXACTLY the rows
                # the encode is about to snapshot — the invariant replay's
                # exactly-once guarantee stands on
                hold = self._hold_flush()  # analyze: ignore[lock-order] -- same contract the flush() chain is baselined under: every put_control and wait inside _hold_flush is deadline-bounded
                if hold is not None:
                    marks = dict(hold.marks)
                else:
                    _obs.counter_inc("serve.checkpoint_flush_timeouts")
                    self.consumer.record_error(
                        "checkpoint hold-flush timed out; snapshot misses "
                        "buffered rows and keeps the previous watermarks"
                    )
                    # degraded but safe-side floor: the previous committed
                    # marks are <= whatever this snapshot contains, so a
                    # replay can duplicate at worst the timed-out window —
                    # never silently drop acked rows
                    marks = dict(self.last_checkpoint_wal_marks or {})
            elif not self.flush():
                # still a consistent snapshot, just missing buffered rows —
                # commit it, but loudly: silent staleness is the real bug
                _obs.counter_inc("serve.checkpoint_flush_timeouts")
                self.consumer.record_error(
                    "checkpoint flush timed out; snapshot misses buffered rows"
                )
            try:
                target = self.registry.checkpoint_target()
                encoded = self.manager.encode_target(
                    target, lock_for=self.registry.lock_for_checkpoint_key
                )
                committed = self.manager.save_now(
                    target,
                    step=step,
                    encoded=encoded,
                    extra={"wal_marks": marks} if marks is not None else None,
                )
            finally:
                if hold is not None:
                    hold.release.set()
            self.last_checkpoint_step = committed
            if marks is not None:
                self.last_checkpoint_wal_marks = marks
        _obs.counter_inc("serve.checkpoints")
        _obs.counter_inc("serve.nonblocking_snapshots")
        return committed

    def _durability_loop(self) -> None:
        poll = self.config.durability_poll
        while not self._durability_stop.wait(timeout=poll):
            if not self.manager.save_due():
                continue
            try:
                self.checkpoint_now()
            except CheckpointError as err:
                # a faulted store must not take the service down: count it,
                # keep serving, retry on the next poll
                _obs.counter_inc("serve.checkpoint_failures")
                self.consumer.record_error(f"checkpoint failed: {err}")

    # ------------------------------------------------------- elastic resize
    def export_span(
        self, job: str, lo: Optional[int] = None, hi: Optional[int] = None
    ) -> Dict[str, Any]:
        """Pack migrating state for one job as a jsonable transfer payload.

        Multistream jobs export the LOCAL row range ``[lo, hi)`` of their
        stacked states; plain jobs export the whole metric (``lo``/``hi``
        ignored).  The coordinator quiesces this worker (forwarder hold +
        flush) first, but a defensive flush here keeps a direct export from
        missing batcher-carried rows.  Exports are pure reads — an aborted
        resize leaves the donor untouched.
        """
        self.flush()
        ejob = self.registry[job]
        with ejob.lock:
            if ejob.is_multistream:
                if lo is None or hi is None:
                    raise MetricsTPUUserError(
                        f"job {job!r} is multistream; export_span needs [lo, hi)"
                    )
                return encode_stream_span(ejob.metric, int(lo), int(hi))
            return encode_metric_transfer(ejob.metric)

    def import_span(
        self,
        job: str,
        width: Optional[int] = None,
        span_lo: int = 0,
        pieces: Tuple[Dict[str, Any], ...] = (),
        plain: bool = False,
    ) -> int:
        """Build this worker's POST-resize metric for ``job`` from transfer
        payloads, staged but not live.

        Multistream: a fresh ``MultiStreamMetric`` of the new span ``width``
        is assembled from donor pieces; each piece's global ``[lo, hi)``
        lands at local rows ``lo - span_lo``.  The pieces must tile the new
        span exactly.  Plain: the donor's whole metric is decoded into a
        fresh instance.  The staged metric only becomes live at
        :meth:`commit_migration` — until then every query reads the
        pre-resize state, so an aborted migration leaves no trace.
        """
        spec = self._builders.get(job)
        if spec is None:
            raise MetricsTPUUserError(
                f"no builder for job {job!r}; this worker cannot host it"
            )
        if plain:
            if len(pieces) != 1:
                raise MetricsTPUUserError(
                    f"plain job {job!r} migrates as exactly one piece, got "
                    f"{len(pieces)}"
                )
            metric = spec.build()
            apply_metric_transfer(metric, pieces[0])
            adopted = 1
        else:
            if width is None or int(width) < 1:
                raise MetricsTPUUserError(
                    f"multistream import for {job!r} needs the new span width"
                )
            base = spec.build()
            metric = MultiStreamMetric(base, num_streams=int(width), device=base.device)
            covered = 0
            for payload in sorted(pieces, key=lambda p: int(p["lo"])):
                arrays = decode_stream_span(payload)
                covered += metric.adopt_stream_slice(
                    int(payload["lo"]) - int(span_lo), arrays
                )
                # a donor's determined attributes (a classifier's input mode)
                # carry over; one that never saw rows leaves them unset
                metric._ckpt_load_extra_state(_determined(payload.get("extra") or {}))
            if covered != int(width):
                raise MetricsTPUUserError(
                    f"import for {job!r} covered {covered} of {width} rows; "
                    "pieces must tile the new span exactly"
                )
            adopted = covered
        with self._migrate_lock:
            self._staged[job] = metric
        _obs.counter_inc("serve.spans_imported", job=job)
        return adopted

    def commit_migration(self, job: str) -> None:
        """Make the staged post-resize metric live (the worker-local half of
        the epoch flip): an in-place pointer swap under the job lock for a
        job this worker already hosts, or a fresh registration for a plain
        job migrating IN."""
        with self._migrate_lock:
            staged = self._staged.pop(job, None)
        if staged is None:
            raise MetricsTPUUserError(f"no staged migration for job {job!r}")
        if job in self.registry:
            self.registry.rebind(job, staged)
        else:
            spec = self._builders[job]
            self.registry.register(
                job,
                staged,
                components=getattr(spec, "components", None),
                export_top_k=getattr(spec, "export_top_k", 0),
            )
        _obs.counter_inc("serve.migrations_committed", job=job)

    def discard_migration(self, job: Optional[str] = None) -> int:
        """Drop staged state (abort path): the live registry was never
        touched, so this is the whole rollback."""
        with self._migrate_lock:
            if job is not None:
                dropped = 1 if self._staged.pop(job, None) is not None else 0
            else:
                dropped = len(self._staged)
                self._staged.clear()
        return dropped

    def retire_job(self, job: str) -> None:
        """Drop a job whose state migrated to another shard (plain-job
        donor after the epoch flip).  The batcher map is consumer-owned, so
        the inert batcher stays; with the job unregistered, any stray row
        is counted unroutable instead of folding into dead state."""
        self.flush()
        self.registry.unregister(job)
        _obs.counter_inc("serve.jobs_retired", job=job)

    # ----------------------------------------------------------------- health
    def health(self) -> Dict[str, Any]:
        consumer = self._threads.get("consumer")
        consumer_alive = bool(consumer is not None and consumer.is_alive())
        if self._draining:
            status = "draining"
        elif self._started and not consumer_alive:
            # the writer died: records pile up and silently go nowhere, so
            # /healthz must stop saying "serving" (load balancers route on it)
            status = "failed"
        else:
            status = "serving"
        payload: Dict[str, Any] = {
            "status": status,
            "consumer_alive": consumer_alive,
            "consumer_errors": self.consumer.errors_total,
            "uptime_secs": round(time.monotonic() - self._t0, 3),
            "queue_depth": self.queue.depth(),
            "records_ingested": sum(
                job.records_ingested for job in self.registry.jobs()
            ),
            "jobs": self.registry.describe(),
            "last_checkpoint_step": self.last_checkpoint_step,
            "restored_step": self.restored_step,
        }
        if self.manager is not None:
            payload["checkpoint_staleness_secs"] = round(self.manager.staleness(), 3)
        if self.config.wal_exactly_once:
            # failover replay reads these: the coordinator re-ships every WAL
            # frame past them to a freshly-restored replacement worker
            payload["wal_marks"] = dict(self.consumer.wal_marks)
        return payload

    # --------------------------------------------------------------- shutdown
    def stop(self, final_checkpoint: bool = True) -> Optional[int]:
        """Graceful drain: reject new records, flush everything buffered,
        optionally commit a final checkpoint, then stop the threads.

        Returns the final checkpoint step (``None`` when skipped)."""
        if self._stopped:
            return self.last_checkpoint_step if final_checkpoint else None
        self._draining = True
        # durability loop first, so the final save below cannot race it
        self._stop_thread("durability", self._durability_stop.set)
        self.consumer.stop.set()
        self._stop_thread("consumer", None, timeout=self.config.drain_timeout)
        committed = None
        if final_checkpoint and self.manager is not None:
            committed = self.checkpoint_now()
            _obs.counter_inc("serve.drains")
        self._teardown_http()
        self._stopped = True
        return committed

    def kill(self) -> None:
        """Preemption drill: stop NOW — drop the queue, skip the final
        checkpoint.  Recovery is whatever the durability loop last committed."""
        if self._stopped:
            return
        self._draining = True
        self._stop_thread("durability", self._durability_stop.set)
        self.consumer.kill.set()
        self._stop_thread("consumer", None, timeout=5.0)
        self._teardown_http()
        self._stopped = True
        _obs.counter_inc("serve.kills")

    def _stop_thread(
        self, name: str, signal: Optional[Any], timeout: float = 5.0
    ) -> None:
        t = self._threads.get(name)
        if signal is not None:
            signal()
        if t is not None and t.is_alive():
            t.join(timeout=timeout)

    def _teardown_http(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._stop_thread("http", None)
            self._httpd.server_close()
