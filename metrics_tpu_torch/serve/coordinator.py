"""Fleet coordinator: one frontend over N shard workers (counterpart of
``metrics_tpu/serve/coordinator.py``: the same merges, the same wire).

The coordinator owns no metric state.  It holds a
:class:`~metrics_tpu_torch.serve.router.ShardRouter` plus one opaque **handle**
per shard and does three things:

* **Parallel ingest** — request threads partition a batch's columns by
  shard (one vectorized ``searchsorted``) and copy them into per-
  ``(shard, job)`` :class:`~metrics_tpu_torch.serve.columnar.ColumnRing`
  staging; one forwarder thread per shard drains ring **views** and ships
  them to its worker.  The HTTP thread never waits on a worker: a full
  ring is a counted rejection (backpressure), a dead worker just leaves
  rows parked in its ring until failover replaces the handle.
* **Scatter-gather queries** — ``top_k`` / ``where`` / ``compute`` fan
  out to every shard through a thread pool with **timed** result waits
  and merge on the coordinator.  Each worker already ranked its own span
  on its device (``MultiStreamMetric.top_k``), so the merge is
  O(k * num_shards) host work;
  contiguous ascending spans make the merged ranking bitwise identical to
  a single worker over the union of streams (ties break lowest-global-id
  first, NaNs sort as ``-inf``/``+inf`` exactly like the device kernel).
* **Liveness + failover** — ``health()`` rolls up per-shard probes (an
  unreachable worker marks the fleet degraded; the HTTP ``/healthz``
  answers 503) and ``failover(shard)`` swaps in a replacement handle from
  the injected ``respawn`` callback (the fleet layer restores the dead
  shard's checkpoint before handing the handle back).  With a WAL
  attached, failover replays the dead shard's log past the replacement's
  checkpoint watermarks *before* installing the handle, so the recovered
  worker answers with every durably-acked row and zero client resends.
* **Durable ingest (optional)** — when constructed with per-shard
  :class:`~metrics_tpu_torch.serve.wal.WalWriter` instances, every accepted
  batch is framed into the target shard's WAL *under the ring mutex* (so
  ring order == seq order) and the ingest ack waits for the frame's
  group-commit fsync.  Forwarders then ship whole frames tagged with
  their seqs; workers dedup on seq, which is what makes both forward
  retries and failover replay exactly-once.

Shard handles are **duck-typed** on purpose: the coordinator never
imports or constructs worker machinery, so ``tools/analyze``'s
serve-blocking and lock-order passes check this whole module with no
opt-outs — nothing on a request thread may block.  The single sanctioned
wait is the WAL durability latch (``WalTicket.wait``): a durable ack
*means* "wait for fsync", and the wait parks on an event the dedicated
writer thread sets after one group commit — the request thread never
touches the disk itself.  A handle provides::

    ingest_columns(job, cols, stream_ids=None, seqs=None) -> bool
    ingest_rows(job, rows)                     -> (accepted, rejected)
    compute(job)                               -> jsonable
    compute_streams(job, local_ids)            -> jsonable list
    top_k(job, k, key, largest)                -> (values, local_ids)
    where(job, op, threshold, k, key)          -> (local_ids, total)
    health()                                   -> dict
    flush(timeout)                             -> bool

:class:`HTTPShard` (below) speaks that protocol to a remote worker's
HTTP surface; the in-process equivalent lives in
``metrics_tpu_torch.serve.fleet``.
"""

from __future__ import annotations

import json
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler
from typing import (
    Any,
    Callable,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
)
from urllib.error import HTTPError, URLError
from urllib.parse import parse_qs, urlparse
from urllib.request import Request, urlopen

import numpy as np

from metrics_tpu_torch.obs import core as _obs
from metrics_tpu_torch.obs.exporters import prometheus_text
from metrics_tpu_torch.serve.columnar import ColumnRing
from metrics_tpu_torch.serve.httpd import _MAX_INGEST_BYTES, PooledHTTPServer
from metrics_tpu_torch.serve.router import migration_plan
from metrics_tpu_torch.serve.wal import replay_frames
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

__all__ = [
    "HTTPShard",
    "FleetCoordinator",
    "FleetHTTPServer",
    "make_fleet_http_server",
]

_FORWARD_POLL_S = 0.005  # forwarder idle poll (timed waits only)
_FORWARD_IDLE_MAX_S = 0.08  # idle backoff cap: keeps N sleeping forwarders
# from preempting request threads every few ms on small hosts
_WAL_ACK_TIMEOUT_S = 10.0  # durable-ack bound: a wedged disk surfaces as an
# ingest error instead of a hung request thread


def _is_scalar(value: Any) -> bool:
    return isinstance(value, (int, float)) and not isinstance(value, bool)


class HTTPShard:
    """Handle over one remote shard worker's HTTP surface.

    Every method is one request/response with a bounded socket timeout;
    nothing here takes a lock, so the lock-order pass has nothing to
    order.  Ingest serializes ring views straight onto the columnar wire
    (``POST /ingest_columns``) — the worker reconstructs the columns with
    ``np.frombuffer``; no per-record objects on either side.
    """

    def __init__(
        self,
        host: str,
        port: int,
        timeout: float = 10.0,
        retries: int = 2,
        retry_backoff: float = 0.05,
    ) -> None:
        self.base = f"http://{host}:{int(port)}"
        self.timeout = float(timeout)
        self.retries = max(0, int(retries))
        self.retry_backoff = float(retry_backoff)
        self.last_checkpoint_wal_marks: Optional[Dict[str, int]] = None

    # ------------------------------------------------------------- plumbing
    def _get(self, path: str) -> Dict[str, Any]:
        """GET with bounded retry on CONNECTION failures only.

        The read endpoints are idempotent, so a refused/reset connection
        (worker mid-restart or mid-resize) earns ``retries`` linear-backoff
        attempts before the error surfaces — one blip must not flip the
        fleet health rollup to degraded.  An ``HTTPError`` means the worker
        answered; replaying cannot change a 4xx/5xx, so it raises at once.
        """
        attempt = 0
        while True:
            try:
                with urlopen(self.base + path, timeout=self.timeout) as resp:
                    return json.loads(resp.read().decode())
            except HTTPError:
                raise
            except (URLError, OSError):
                if attempt >= self.retries:
                    raise
                attempt += 1
                _obs.counter_inc("serve.shard_retries")
                time.sleep(self.retry_backoff * attempt)

    def _post(
        self,
        path: str,
        body: bytes,
        content_type: str,
        idempotent: bool = False,
    ) -> Tuple[int, Dict[str, Any]]:
        """POST; connection failures retry only when ``idempotent``.

        A blind POST retry could double-apply rows (the worker may have
        committed the first attempt before the connection dropped), so by
        default connection errors surface at once.  WAL-framed ingest
        carries per-frame sequence numbers the worker dedups on, which is
        exactly the idempotency key a safe retry needs — those calls opt
        in and get the same bounded linear-backoff retry as ``_get``.
        """
        attempt = 0
        while True:
            req = Request(
                self.base + path,
                data=body,
                headers={"Content-Type": content_type},
                method="POST",
            )
            try:
                with urlopen(req, timeout=self.timeout) as resp:
                    return resp.status, json.loads(resp.read().decode())
            except HTTPError as err:
                raw = err.read()
                try:
                    payload = json.loads(raw.decode()) if raw else {}
                except ValueError:
                    payload = {}
                return err.code, payload
            except (URLError, OSError):
                if not idempotent or attempt >= self.retries:
                    raise
                attempt += 1
                _obs.counter_inc("serve.shard_retries")
                time.sleep(self.retry_backoff * attempt)

    # --------------------------------------------------------------- ingest
    def ingest_columns(
        self,
        job: str,
        cols: Sequence[np.ndarray],
        stream_ids: Optional[np.ndarray] = None,
        seqs: Optional[Sequence[Tuple[Optional[int], int]]] = None,
    ) -> bool:
        """Ship one columnar batch; ``seqs`` carries WAL frame spans.

        ``seqs=[(seq_or_None, rows), ...]`` partitions the batch into the
        WAL frames it arrived as; the worker dedups framed spans on seq,
        so a seq-tagged POST is idempotent and connection failures earn a
        retry (a duplicate delivery lands exactly once).  Untagged ships
        keep the original never-blind-retry contract.
        """
        cols = [np.ascontiguousarray(c) for c in cols]
        header: Dict[str, Any] = {
            "job": job,
            "rows": int(cols[0].shape[0]),
            "arity": len(cols),
            "dtype": cols[0].dtype.str,
            "ids": stream_ids is not None,
        }
        if seqs is not None:
            header["seqs"] = [
                [None if s is None else int(s), int(r)] for s, r in seqs
            ]
        parts = [json.dumps(header).encode(), b"\n"]
        parts.extend(c.tobytes() for c in cols)
        if stream_ids is not None:
            parts.append(np.ascontiguousarray(stream_ids, dtype="<i4").tobytes())
        status, _ = self._post(
            "/ingest_columns",
            b"".join(parts),
            "application/octet-stream",
            idempotent=seqs is not None,
        )
        return status == 200

    def ingest_rows(
        self, job: str, rows: Sequence[Tuple[Tuple[Any, ...], Optional[int]]]
    ) -> Tuple[int, int]:
        records = [
            {"values": list(values)}
            if stream_id is None
            else {"values": list(values), "stream_id": int(stream_id)}
            for values, stream_id in rows
        ]
        status, payload = self._post(
            "/ingest",
            json.dumps({"job": job, "records": records}).encode(),
            "application/json",
        )
        if status not in (200, 429):
            raise MetricsTPUUserError(
                f"shard {self.base} rejected ingest: HTTP {status} {payload}"
            )
        return int(payload.get("accepted", 0)), int(payload.get("rejected", 0))

    # ---------------------------------------------------------------- reads
    def compute(self, job: str) -> Any:
        return self._get(f"/query?job={job}")["value"]

    def compute_streams(self, job: str, local_ids: Sequence[int]) -> List[Any]:
        ids = ",".join(str(int(i)) for i in local_ids)
        return self._get(f"/query?job={job}&streams={ids}")["values"]

    def top_k(
        self, job: str, k: int, key: Any = None, largest: bool = True
    ) -> Tuple[List[float], List[int]]:
        path = f"/query?job={job}&top_k={int(k)}&largest={1 if largest else 0}"
        if key is not None:
            path += f"&key={key}"
        out = self._get(path)
        return out["top_k"], out["stream_ids"]

    def where(
        self, job: str, op: str, threshold: float, k: int, key: Any = None
    ) -> Tuple[List[int], int]:
        path = f"/query?job={job}&where={op}:{threshold!r}&k={int(k)}"
        if key is not None:
            path += f"&key={key}"
        out = self._get(path)
        return out["stream_ids"], int(out["total_matches"])

    # ------------------------------------------------------------ liveness
    def health(self) -> Dict[str, Any]:
        try:
            return self._get("/healthz")
        except HTTPError as err:  # worker answered 503 with a JSON body
            raw = err.read()
            try:
                return json.loads(raw.decode())
            except ValueError:
                return {"status": f"http_{err.code}"}

    def flush(self, timeout: float = 10.0) -> bool:
        status, payload = self._post(
            f"/flush?timeout={float(timeout)!r}", b"{}", "application/json"
        )
        return status == 200 and bool(payload.get("flushed"))

    def checkpoint(self) -> int:
        status, payload = self._post("/checkpoint", b"{}", "application/json")
        if status != 200:
            raise MetricsTPUUserError(
                f"shard {self.base} checkpoint failed: HTTP {status} {payload}"
            )
        marks = payload.get("wal_marks")
        # stash the committed watermarks so the owner (fleet layer or a
        # soak harness holding the WalWriter) can truncate covered segments
        self.last_checkpoint_wal_marks = (
            {str(j): int(s) for j, s in marks.items()}
            if isinstance(marks, dict)
            else None
        )
        return int(payload["step"])

    # ------------------------------------------------------ elastic resize
    def _post_json(self, path: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        status, out = self._post(
            path, json.dumps(payload).encode(), "application/json"
        )
        if status != 200:
            raise MetricsTPUUserError(
                f"shard {self.base} {path} failed: HTTP {status} {out}"
            )
        return out

    def migrate_out(
        self, job: str, lo: Optional[int] = None, hi: Optional[int] = None
    ) -> Dict[str, Any]:
        body: Dict[str, Any] = {"job": job}
        if lo is not None:
            body["lo"], body["hi"] = int(lo), int(hi)
        return self._post_json("/migrate_out", body)

    def migrate_in(
        self,
        job: str,
        width: Optional[int] = None,
        span_lo: int = 0,
        pieces: Sequence[Dict[str, Any]] = (),
        plain: bool = False,
    ) -> int:
        out = self._post_json(
            "/migrate_in",
            {
                "job": job,
                "width": width,
                "span_lo": int(span_lo),
                "pieces": list(pieces),
                "plain": bool(plain),
            },
        )
        return int(out.get("adopted", 0))

    def commit_migration(self, job: str) -> None:
        self._post_json("/migrate_commit", {"job": job})

    def discard_migration(self, job: str) -> None:
        self._post_json("/migrate_commit", {"job": job, "discard": True})

    def retire_job(self, job: str) -> None:
        self._post_json("/retire_job", {"job": job})


class FleetCoordinator:
    """Routes ingest to shard rings and merges scatter-gather reads.

    Args:
        router: a built :class:`~metrics_tpu_torch.serve.router.ShardRouter`.
        handles: one shard handle per shard, index-aligned with the
            router's shard ids (see the module docstring for the duck
            protocol).
        respawn: optional ``shard -> handle`` callback used by
            :meth:`failover`; the callback owns restoring the dead
            shard's checkpoint before returning the replacement.
        ring_capacity: rows per ``(shard, job)`` staging ring.
        ingest_dtype: dtype scalar JSON records are staged at (the
            columnar hot path; float32 halves the wire for serving).
        query_timeout: per-shard bound on every scatter-gather wait.
        wal: optional ``{shard: WalWriter}`` map; shards with a writer get
            durable-ack ingest (frames fsync'd before the ack) and
            exactly-once failover replay.  Shards absent from the map keep
            queue-ack semantics.
    """

    def __init__(
        self,
        router: Any,
        handles: Sequence[Any],
        respawn: Optional[Callable[[int], Any]] = None,
        provision: Optional[Callable[[int, Any], Any]] = None,
        retire: Optional[Callable[[int], None]] = None,
        ring_capacity: int = 8192,
        ingest_dtype: Any = np.float32,
        query_timeout: float = 30.0,
        wal: Optional[Dict[int, Any]] = None,
    ) -> None:
        if len(handles) != router.num_shards:
            raise MetricsTPUUserError(
                f"router expects {router.num_shards} shard(s), "
                f"got {len(handles)} handle(s)"
            )
        self.router = router
        self._handles: List[Any] = list(handles)
        self._respawn = respawn
        self._provision = provision
        self._retire = retire
        self.ring_capacity = int(ring_capacity)
        self.ingest_dtype = np.dtype(ingest_dtype)
        self.query_timeout = float(query_timeout)
        self._wal: Dict[int, Any] = dict(wal) if wal else {}
        self._rings: Dict[Tuple[int, str], ColumnRing] = {}
        self._rings_lock = threading.Lock()
        try:  # named in the runtime lock-witness graph
            self._rings_lock.witness_name = "FleetCoordinator._rings_lock"
        except AttributeError:
            pass
        # generous cap + lazy thread creation: scatter width survives grows
        # without ever rebuilding the pool mid-flight
        self._pool = ThreadPoolExecutor(
            max_workers=max(16, 2 * len(self._handles)),
            thread_name_prefix="fleet-scatter",
        )
        self._stop = threading.Event()
        self._forwarders: Dict[int, threading.Thread] = {}
        self._started = False
        # jobs whose spans are mid-migration: forwarders park their rows
        self._held_jobs: frozenset = frozenset()
        # set <=> no resize in flight; flush() and queries gate on it
        self._resize_done = threading.Event()
        self._resize_done.set()
        self._resize_claim = threading.Lock()
        try:
            self._resize_claim.witness_name = "FleetCoordinator._resize_claim"
        except AttributeError:
            pass

    # ---------------------------------------------------------------- lifecycle
    @property
    def num_shards(self) -> int:
        return self.router.num_shards

    def handle(self, shard: int) -> Any:
        return self._handles[int(shard)]

    def start(self) -> "FleetCoordinator":
        """Spawn one forwarder thread per shard (idempotent)."""
        if self._started:
            return self
        self._started = True
        for shard in range(self.num_shards):
            self._spawn_forwarder(shard)
        return self

    def _spawn_forwarder(self, shard: int) -> None:
        t = threading.Thread(
            target=self._forward_loop,
            args=(shard,),
            name=f"fleet-forward-{shard}",
            daemon=True,
        )
        t.start()
        self._forwarders[shard] = t

    def stop(self) -> None:
        self._stop.set()
        for t in self._forwarders.values():
            t.join(timeout=5.0)
        self._forwarders = {}
        self._pool.shutdown(wait=False)

    # ------------------------------------------------------------------ ingest
    def _ring(self, shard: int, job: str, arity: int, with_ids: bool) -> ColumnRing:
        key = (int(shard), job)
        ring = self._rings.get(key)
        if ring is not None:
            return ring
        with self._rings_lock:
            ring = self._rings.get(key)
            if ring is None:
                ring = ColumnRing(
                    arity,
                    capacity=self.ring_capacity,
                    with_ids=with_ids,
                    dtype=self.ingest_dtype,
                )
                self._rings[key] = ring
            return ring

    def _shard_rings(self, shard: int) -> List[Tuple[str, ColumnRing]]:
        # dict reads race benignly with _ring() inserts (GIL-atomic); a
        # ring missed this pass is drained on the next poll
        return [(job, r) for (s, job), r in list(self._rings.items()) if s == shard]

    def _framed_put(
        self,
        shard: int,
        ring: ColumnRing,
        job: str,
        cols: List[np.ndarray],
        ids: Optional[np.ndarray],
        tickets: Dict[int, Any],
    ) -> bool:
        """``ring.put`` that frames the batch into the shard's WAL.

        The frame callable runs *under the ring mutex, after acceptance*,
        with the dtype-converted buffers the ring actually staged — so the
        WAL records exactly the bytes that will ship, a rejected put never
        consumes a seq, and ring order always equals seq order.  Only the
        *last* ticket per shard is kept: the writer thread commits groups
        in order, so its durability implies every earlier frame's.
        """
        writer = self._wal.get(shard)
        if writer is None:
            return ring.put(cols, ids)

        def _frame(arrs: List[np.ndarray], fids: Optional[np.ndarray]) -> int:
            ticket = writer.append(job, arrs, fids)
            tickets[shard] = ticket
            return ticket.seq

        return ring.put(cols, ids, frame=_frame)

    def _await_durable(self, tickets: Dict[int, Any]) -> None:
        """Block until every staged frame's group commit lands.

        This is the durable-ack barrier: the rows are already staged (they
        WILL reach a worker), so a failed or timed-out fsync cannot be
        reported as a rejection — it surfaces as an error the client sees
        instead of a 200, and the worker-side seq dedup absorbs the
        duplicate if the client then re-sends rows that did land.
        """
        for shard, ticket in tickets.items():
            if not ticket.wait(_WAL_ACK_TIMEOUT_S):
                _obs.counter_inc("serve.wal_ack_failures", shard=str(shard))
                raise MetricsTPUUserError(
                    f"WAL group commit failed for shard {shard}: rows are "
                    "staged but not durable"
                )

    def ingest_columns(
        self,
        job: str,
        cols: Sequence[np.ndarray],
        stream_ids: Optional[np.ndarray] = None,
    ) -> Tuple[int, int]:
        """Partition one columnar batch across shard rings.

        Returns ``(accepted, rejected)`` row counts; a rejection means the
        target shard's ring was full (its worker is slow or dead) — the
        caller sees backpressure immediately instead of queueing unbounded.
        With a WAL attached, the return waits for every accepted frame's
        group-commit fsync: a ``200`` built from this count is a durable
        ack, not a queue ack.
        """
        cols = [np.asarray(c).reshape(-1) for c in cols]
        n = int(cols[0].shape[0]) if cols else 0
        if n == 0:
            return 0, 0
        tickets: Dict[int, Any] = {}
        if self.router.is_multistream(job):
            if stream_ids is None:
                raise MetricsTPUUserError(
                    f"job {job!r} is multistream; ingest needs stream_ids"
                )
            router = self.router
            parts = router.partition_ids(job, stream_ids)
            ids64 = np.asarray(stream_ids, np.int64).reshape(-1)
            accepted = rejected = 0
            for shard, (positions, _local_ids) in parts.items():
                ring = self._ring(shard, job, len(cols), with_ids=True)
                # rings stage GLOBAL stream ids: the shard key is only an
                # affinity hint, and the forwarder re-resolves each row's
                # owner at ship time — so rows parked across an elastic
                # resize drain to the post-flip owner automatically
                ok = self._framed_put(
                    shard,
                    ring,
                    job,
                    [c[positions] for c in cols],
                    ids64[positions],
                    tickets,
                )
                if ok:
                    accepted += int(positions.shape[0])
                else:
                    rejected += int(positions.shape[0])
            self._await_durable(tickets)
            return accepted, rejected
        shard = self.router.owner(job)
        ring = self._ring(shard, job, len(cols), with_ids=False)
        ok = self._framed_put(shard, ring, job, list(cols), None, tickets)
        self._await_durable(tickets)
        return (n, 0) if ok else (0, n)

    def ingest_records(
        self, job: str, records: Sequence[Tuple[Tuple[Any, ...], Optional[int]]]
    ) -> Tuple[int, int]:
        """Ingest parsed ``(values, stream_id)`` records.

        Scalar rows take the columnar hot path (one transpose into numpy,
        then :meth:`ingest_columns`); rows with array-valued fields fall
        back to per-shard record forwarding through ``handle.ingest_rows``.
        """
        if not records:
            return 0, 0
        multistream = self.router.is_multistream(job)
        scalar = all(
            all(_is_scalar(v) for v in values) for values, _sid in records
        )
        same_arity = len({len(values) for values, _sid in records}) == 1
        if multistream:
            missing = sum(1 for _v, sid in records if sid is None)
            if missing:
                _obs.counter_inc(
                    "serve.records_rejected", missing, reason="no_stream_id"
                )
                records = [r for r in records if r[1] is not None]
                if not records:
                    return 0, missing
        else:
            missing = 0
        accepted = rejected = 0
        if scalar and same_arity:
            arity = len(records[0][0])
            vals = np.asarray(
                [values for values, _sid in records], self.ingest_dtype
            )
            cols = [vals[:, i] for i in range(arity)]
            ids = (
                np.asarray([sid for _v, sid in records], np.int64)
                if multistream
                else None
            )
            accepted, rejected = self.ingest_columns(job, cols, ids)
            return accepted, rejected + missing
        # slow path: nested array values keep per-record framing.  This
        # path ships straight to a worker (no ring to park in), so a job
        # mid-migration rejects the whole batch — backpressure, never a
        # row landing on a donor whose span already moved
        if job in self._held_jobs:
            n_held = len(records)
            _obs.counter_inc(
                "serve.records_rejected", n_held, reason="migration"
            )
            return 0, n_held + missing
        by_shard: Dict[int, List[Tuple[Tuple[Any, ...], Optional[int]]]] = {}
        for values, sid in records:
            if multistream:
                shard, local = self.router.local_id(job, int(sid))
                by_shard.setdefault(shard, []).append((values, local))
            else:
                by_shard.setdefault(self.router.owner(job), []).append(
                    (values, None)
                )
        for shard, rows in by_shard.items():
            try:
                got, lost = self._handles[shard].ingest_rows(job, rows)
            except (OSError, URLError, MetricsTPUUserError):
                _obs.counter_inc(
                    "serve.fleet_forward_errors", shard=str(shard)
                )
                got, lost = 0, len(rows)
            accepted += got
            rejected += lost
        return accepted, rejected + missing

    def _forward_loop(self, shard: int) -> None:
        """Drain this shard's rings and ship views to each row's OWNER.

        Rings stage global stream ids, and ownership is re-resolved against
        the live router at ship time: the ring's shard key is only the
        affinity the rows were staged under.  Each drain ships its maximal
        single-owner *prefix* (arrival order is preserved, so parked rows
        never leapfrog) — after an epoch flip the very same parked rows
        drain to their new owner with no re-staging.

        A worker that rejects (429) or errors leaves the rows parked in
        the ring — ``commit(0)`` releases the drain without consuming, so
        the same rows retry after backoff (and survive a failover: the
        replacement handle picks them up on the next pass).  Jobs held by
        an in-flight resize are skipped whole.

        Idle waits back off geometrically (5ms up to 80ms): a quiescent
        fleet must not have N forwarder threads waking every few
        milliseconds and stealing scheduler slices from query threads;
        the first batch after an idle stretch waits at most the cap,
        which forwarding (asynchronous by design) absorbs.  Backoff time
        spent after a failed pass accumulates in
        ``serve.forwarder_backoff_secs`` (autoscaler pressure signal).
        A forwarder whose shard left the fleet (shrink) exits once its
        rings run dry.
        """
        idle_wait = _FORWARD_POLL_S
        while not self._stop.is_set():
            moved = False
            errored = False
            router = self.router
            held = self._held_jobs
            use_wal = bool(self._wal)
            for job, ring in self._shard_rings(shard):
                if job in held:
                    continue
                if use_wal:
                    got = ring.drain_frames(timeout=0.0)
                else:
                    got = ring.drain(timeout=0.0)
                if got is None:
                    continue
                if use_wal:
                    views, id_view, n, spans = got
                else:
                    views, id_view, n = got
                    spans = None
                try:
                    if id_view is not None:
                        owners = router.owner_of_ids(job, id_view)
                        # maximal single-owner prefix: argmax finds the
                        # first owner change (fixed-shape, no nonzero)
                        mixed = owners != owners[0]
                        p = int(np.argmax(mixed)) if bool(mixed.any()) else n
                        target = int(owners[0])
                    else:
                        p, target = n, router.owner(job)
                    ship_spans: Optional[List[Tuple[Optional[int], int]]]
                    demoted = 0
                    if spans is None:
                        ship_spans = None
                    elif p >= n:
                        ship_spans = list(spans)
                    else:
                        # clip the owner prefix DOWN to a frame boundary:
                        # half a frame under a seq would let a retry or a
                        # replay double-apply the other half
                        boundary = 0
                        clipped: List[Tuple[Optional[int], int]] = []
                        for seq, rows in spans:
                            if boundary + int(rows) > p:
                                break
                            clipped.append((seq, int(rows)))
                            boundary += int(rows)
                        if boundary:
                            p = boundary
                            ship_spans = clipped
                        else:
                            # the owner split lands INSIDE the front frame
                            # (a resize moved part of a framed span): ship
                            # the prefix unframed; commit() demotes the
                            # remainder — the documented resize/WAL caveat
                            ship_spans = [(None, p)]
                            demoted = p
                    if ship_spans is not None and all(
                        s is None for s, _r in ship_spans
                    ):
                        ship_spans = None  # nothing framed: plain wire
                    if id_view is not None:
                        lo = router.span(job, target)[0]
                        ship_ids = (
                            id_view[:p].astype(np.int64) - lo
                        ).astype(np.int32)
                        ship_views = [v[:p] for v in views]
                    else:
                        ship_ids = None
                        ship_views = (
                            views if p >= n else [v[:p] for v in views]
                        )
                    if ship_spans is not None:
                        ok = self._handles[target].ingest_columns(
                            job, ship_views, ship_ids, seqs=ship_spans
                        )
                    else:
                        ok = self._handles[target].ingest_columns(
                            job, ship_views, ship_ids
                        )
                    if ok and demoted:
                        _obs.counter_inc("serve.wal_unframed_rows", demoted)
                except (OSError, URLError, IndexError):
                    # IndexError: the router moved under us (shrink); the
                    # rows park and re-route against the new epoch
                    ok = False
                    p = 0
                if ok:
                    ring.commit(p)
                    _obs.counter_inc(
                        "serve.fleet_rows_forwarded", p, shard=str(shard)
                    )
                    moved = True
                else:
                    ring.commit(0)
                    errored = True
                    _obs.counter_inc(
                        "serve.fleet_forward_errors", shard=str(shard)
                    )
            if moved:
                idle_wait = _FORWARD_POLL_S
            else:
                if (
                    shard >= self.router.num_shards
                    and not any(
                        r.depth() for _j, r in self._shard_rings(shard)
                    )
                ):
                    self._forwarders.pop(shard, None)
                    return  # retired shard, rings dry: done for good
                self._stop.wait(idle_wait)
                if errored:
                    _obs.counter_inc(
                        "serve.forwarder_backoff_secs",
                        idle_wait,
                        shard=str(shard),
                    )
                idle_wait = min(idle_wait * 2, _FORWARD_IDLE_MAX_S)

    def staged_rows(self) -> int:
        """Rows parked in staging rings, not yet on a worker."""
        return sum(r.depth() for r in list(self._rings.values()))

    def flush(self, timeout: float = 10.0) -> bool:
        """Wait for staging rings to drain, then flush every worker.

        A flush that lands mid-resize WAITS for the migration (held rows
        are parked on purpose and will drain after the epoch flip) instead
        of reporting success with rows still parked; ``False`` means the
        deadline passed with rows still in flight, never that rows were
        forgotten.
        """
        deadline = time.monotonic() + float(timeout)
        while True:
            # gate on the resize first: held rings cannot drain until the
            # flip releases them, so polling depths alone would spin
            if not self._resize_done.wait(
                timeout=max(0.0, deadline - time.monotonic())
            ):
                return False
            while self.staged_rows() > 0:
                if time.monotonic() >= deadline:
                    return False
                time.sleep(_FORWARD_POLL_S)
            if self._resize_done.is_set():
                break  # drained, and no new resize started meanwhile
        remaining = max(0.1, deadline - time.monotonic())
        results = self._scatter(
            "flush", lambda s, h: h.flush(remaining), count=False
        )
        return all(bool(ok) for ok in results.values())

    # ----------------------------------------------------------- scatter-gather
    def _scatter(
        self,
        what: str,
        fn: Callable[[int, Any], Any],
        count: bool = True,
        router: Optional[Any] = None,
    ) -> Dict[int, Any]:
        if count:
            _obs.counter_inc("serve.scatter_queries", op=what)
        width = (router or self.router).num_shards
        futures = {
            s: self._pool.submit(fn, s, self._handles[s]) for s in range(width)
        }
        return {
            s: f.result(timeout=self.query_timeout) for s, f in futures.items()
        }

    def _with_router(self, fn: Callable[[Any], Any]) -> Any:
        """Run one scatter read against a router snapshot, retrying when an
        elastic resize flips the epoch mid-read.

        A read that raced the flip can see a worker answering for a span
        it no longer (or does not yet) own; retrying against the new
        snapshot makes the read linearize cleanly on one side of the flip.
        Errors unrelated to a flip surface on the first attempt.
        """
        deadline = time.monotonic() + self.query_timeout
        while True:
            router = self.router
            try:
                return fn(router)
            except Exception:
                if router is self.router and self._resize_done.is_set():
                    raise
                if time.monotonic() >= deadline:
                    raise
                time.sleep(_FORWARD_POLL_S)

    def top_k(
        self, job: str, k: int, key: Any = None, largest: bool = True
    ) -> Tuple[List[float], List[int]]:
        """Global top-k over the union of streams: per-shard device top-k,
        merged O(k * num_shards) on the host.

        Exactness: the global top-k is a subset of the union of local
        top-ks (each shard returns min(k, span_width) candidates), and the
        merge ranks by ``(score, global_id)`` with NaN scored as the
        device kernel scores it — so the result is the single-worker
        ranking, ties and all.
        """
        k = int(k)
        total = self.router.num_streams(job)
        if not 1 <= k <= total:
            raise MetricsTPUUserError(
                f"top_k k must be in [1, {total}], got {k}"
            )

        def _run(router: Any) -> Tuple[List[float], List[int]]:
            per = self._scatter(
                "top_k",
                lambda s, h: h.top_k(
                    job,
                    min(k, router.span_width(job, s)),
                    key=key,
                    largest=largest,
                ),
                router=router,
            )
            fill = -math.inf if largest else math.inf
            candidates: List[Tuple[float, int, float]] = []
            for shard, (values, local_ids) in per.items():
                lo, _hi = router.span(job, shard)
                for value, local in zip(values, local_ids):
                    value = float(value)
                    score = fill if math.isnan(value) else value
                    candidates.append((score, lo + int(local), value))
            candidates.sort(
                key=lambda c: ((-c[0] if largest else c[0]), c[1])
            )
            top = candidates[:k]
            return [v for _s, _g, v in top], [g for _s, g, _v in top]

        return self._with_router(_run)

    def where(
        self, job: str, op: str, threshold: float, k: int, key: Any = None
    ) -> Tuple[List[int], int]:
        """First-k matching global stream ids + total match count.

        Per-shard ids ascend within ascending spans, so concatenating in
        shard order IS global ascending order — same ids, same order, as
        one worker over the whole axis.
        """
        k = int(k)

        def _run(router: Any) -> Tuple[List[int], int]:
            per = self._scatter(
                "where",
                lambda s, h: h.where(
                    job,
                    op,
                    threshold,
                    min(k, router.span_width(job, s)),
                    key=key,
                ),
                router=router,
            )
            gids: List[int] = []
            total = 0
            for shard in sorted(per):
                local_ids, matches = per[shard]
                lo, _hi = router.span(job, shard)
                gids.extend(lo + int(i) for i in local_ids)
                total += int(matches)
            return gids[:k], total

        return self._with_router(_run)

    def compute(self, job: str) -> Any:
        """One job's full value: owner read (plain) or span concat
        (multistream) — the stream axis reassembles in global order."""
        if not self.router.is_multistream(job):
            _obs.counter_inc("serve.scatter_queries", op="compute")
            return self._with_router(
                lambda router: self._handles[router.owner(job)].compute(job)
            )

        def _run(router: Any) -> Any:
            per = self._scatter(
                "compute", lambda s, h: h.compute(job), router=router
            )
            total = router.num_streams(job)
            merged = _concat_streams([per[s] for s in sorted(per)])
            _require_width(merged, total)
            return merged

        return self._with_router(_run)

    def compute_streams(self, job: str, stream_ids: Sequence[int]) -> List[Any]:
        """Per-stream reads reassembled in the caller's input order."""
        total = self.router.num_streams(job)
        ids = np.asarray([int(i) for i in stream_ids], np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= total):
            raise MetricsTPUUserError(
                f"stream ids must be in [0, {total}), got "
                f"{[int(i) for i in ids if i < 0 or i >= total]}"
            )
        _obs.counter_inc("serve.scatter_queries", op="compute_streams")

        def _run(router: Any) -> List[Any]:
            parts = router.partition_ids(job, ids)
            futures = {
                s: self._pool.submit(
                    self._handles[s].compute_streams,
                    job,
                    [int(i) for i in local],
                )
                for s, (_pos, local) in parts.items()
            }
            out: List[Any] = [None] * int(ids.shape[0])
            for s, (positions, _local) in parts.items():
                values = futures[s].result(timeout=self.query_timeout)
                for position, value in zip(positions, values):
                    out[int(position)] = value
            return out

        return self._with_router(_run)

    def compute_all(self) -> Dict[str, Any]:
        """Every routed job's value, shards merged (the fleet-wide answer
        the failover drill compares bitwise)."""
        return {job: self.compute(job) for job in self.router.jobs()}

    # --------------------------------------------------------------- liveness
    def health(self) -> Dict[str, Any]:
        """Per-shard probe rollup; ``status`` is ``"serving"`` only when
        every shard is."""
        router = self.router
        width = router.num_shards
        futures = {
            s: self._pool.submit(self._handles[s].health) for s in range(width)
        }
        shards: List[Dict[str, Any]] = []
        for s in range(width):
            try:
                info = futures[s].result(timeout=self.query_timeout)
            except Exception as err:  # noqa: BLE001 — a dead worker is data, not a crash
                info = {"status": "unreachable", "error": str(err)}
            shards.append(dict(info, shard=s))
        dead = [s for s, info in enumerate(shards) if info.get("status") != "serving"]
        return {
            "status": "serving" if not dead else "degraded",
            "num_shards": width,
            "epoch": int(getattr(router, "epoch", 0)),
            "resizing": not self._resize_done.is_set(),
            "dead_shards": dead,
            "staged_rows": self.staged_rows(),
            "shards": shards,
        }

    def failover(self, shard: int) -> Any:
        """Replace a dead shard's handle via the ``respawn`` callback.

        The callback restores the shard's latest checkpoint into a fresh
        worker and returns its handle; rows parked in the shard's staging
        rings then drain to the replacement automatically.

        With a WAL attached, the shard's log is replayed into the
        replacement *before* the handle goes live: every frame past the
        restored checkpoint's applied-seq watermarks ships seq-tagged (the
        worker floor dedups any frame the checkpoint already covered), so
        the recovered worker answers queries with every durably-acked row
        — no client resend, bitwise the same state as a worker that never
        died.  Rows that drained to a *different* owner before the crash
        (possible only after a resize re-homed part of this shard's span)
        are skipped: that owner still holds them.
        """
        if self._respawn is None:
            raise MetricsTPUUserError(
                "failover needs a respawn callback; construct the "
                "coordinator with respawn=..."
            )
        shard = int(shard)
        if not 0 <= shard < self.num_shards:
            raise MetricsTPUUserError(
                f"shard must be in [0, {self.num_shards}), got {shard}"
            )
        replacement = self._respawn(shard)
        writer = self._wal.get(shard)
        if writer is not None:
            self._replay_wal(shard, writer, replacement)
        self._handles[shard] = replacement
        _obs.counter_inc("serve.failovers", shard=str(shard))
        return replacement

    def _replay_wal(self, shard: int, writer: Any, replacement: Any) -> None:
        """Push a shard's WAL past the replacement's watermarks into it."""
        try:
            info = replacement.health()
            raw = info.get("wal_marks") or {}
        except Exception:  # noqa: BLE001 — a probe failure just means replay-all
            raw = {}
        marks = {str(j): int(s) for j, s in raw.items()}
        router = self.router
        deadline = time.monotonic() + self.query_timeout
        replayed = 0
        for frame in replay_frames(
            writer.directory, watermarks=marks, on_error="skip_segment"
        ):
            if frame.stream_ids is not None:
                owners = router.owner_of_ids(
                    frame.job, frame.stream_ids.astype(np.int64)
                )
                mask = owners == shard
                if not bool(mask.any()):
                    continue  # re-homed by a resize: the new owner has them
                lo = router.span(frame.job, shard)[0]
                ship_ids = (
                    frame.stream_ids[mask].astype(np.int64) - lo
                ).astype(np.int32)
                ship_cols = [np.ascontiguousarray(c[mask]) for c in frame.cols]
            else:
                if router.owner(frame.job) != shard:
                    continue
                ship_ids = None
                ship_cols = [np.ascontiguousarray(c) for c in frame.cols]
            rows = int(ship_cols[0].shape[0])
            while True:
                ok = False
                try:
                    ok = replacement.ingest_columns(
                        frame.job, ship_cols, ship_ids, seqs=[(frame.seq, rows)]
                    )
                except (OSError, URLError):
                    ok = False
                if ok:
                    replayed += rows
                    break
                if time.monotonic() >= deadline:
                    raise MetricsTPUUserError(
                        f"WAL replay to shard {shard} replacement stalled "
                        f"at seq {frame.seq}"
                    )
                time.sleep(_FORWARD_POLL_S)  # replacement backpressure
        if replayed:
            _obs.counter_inc(
                "serve.wal_replayed_rows", replayed, shard=str(shard)
            )

    # ---------------------------------------------------------------- elastic
    def ring_stats(self) -> Dict[str, Any]:
        """Occupancy snapshot of every staging ring — the autoscaler's
        input signal (and an operator debugging read)."""
        rings = [
            {
                "shard": s,
                "job": job,
                "depth": ring.depth(),
                "pending": ring.pending(),
                "high_water": ring.high_water(),
            }
            for (s, job), ring in sorted(self._rings.items())
        ]
        return {
            "num_shards": self.router.num_shards,
            "epoch": int(getattr(self.router, "epoch", 0)),
            "ring_capacity": self.ring_capacity,
            "rings": rings,
            "staged_rows": sum(r["depth"] for r in rings),
            "held_jobs": sorted(self._held_jobs),
            "resizing": not self._resize_done.is_set(),
        }

    def resize(
        self,
        num_shards: int,
        timeout: float = 60.0,
        phase_hook: Optional[Callable[[str], None]] = None,
    ) -> Dict[str, Any]:
        """Live fleet resize: migrate every span that changes owner, then
        flip the router to a new epoch — ingest and queries keep flowing.

        The protocol (each boundary reported to ``phase_hook``):

        1. **planned** — build the target router and the minimal
           :func:`~metrics_tpu_torch.serve.router.migration_plan` between epochs.
        2. **provisioned** — fresh workers for added shards (grow only).
        3. **held** — forwarders stop shipping the affected jobs; their
           rows park in the staging rings (whole-batch backpressure is the
           only degradation), and the one drain per ring that may already
           be in flight is waited out.
        4. **quiesced** — every old worker flushes, so queued rows are in
           the exported state.
        5. **staged** — donors export each moving span (a pure read; they
           keep serving), recipients assemble their post-resize metrics,
           STAGED — nothing is live yet.
        6. **flipped** — the handle list is extended, then the router
           reference is swapped: one atomic store is the commit point.
        7. **committed** — each affected worker swaps its staged metric
           live (a pointer swap under the job lock), then the holds lift.
        8. **released / drained** — parked rows re-resolve their owner
           against the new epoch and drain; donor shards retire plain jobs
           that moved away; shrink retires the departed workers.

        Any failure BEFORE the flip aborts cleanly: exports were reads,
        staged state is discarded, provisioned workers are retired, and
        the old epoch keeps serving — the remedy is ``failover`` of the
        failed shard and a fresh ``resize``.  Failure AFTER the flip is
        ordinary failover territory for the shard that failed; the holds
        for its jobs stay up (rows keep parking — safe, not silent) until
        the operator resolves it.
        """
        n = int(num_shards)
        if n < 1:
            raise MetricsTPUUserError(f"num_shards must be >= 1, got {n}")
        old_router = self.router
        if n > old_router.num_shards and self._provision is None:
            raise MetricsTPUUserError(
                "growing the fleet needs a provision callback; construct "
                "the coordinator with provision=..."
            )
        with self._resize_claim:
            if not self._resize_done.is_set():
                raise MetricsTPUUserError("a resize is already in flight")
            self._resize_done.clear()
        hook = phase_hook or (lambda _phase: None)
        t0 = time.monotonic()
        deadline = t0 + float(timeout)
        staged_handles: Dict[int, Any] = {}
        staged_imports: List[Tuple[int, Any, str]] = []
        retire_plain: List[Tuple[int, str]] = []
        flipped = False
        try:
            new_router = old_router.resized(n)
            plan = migration_plan(old_router, new_router)
            held = frozenset(plan.jobs())
            hook("planned")
            for shard in range(old_router.num_shards, n):
                staged_handles[shard] = self._provision(shard, new_router)
            hook("provisioned")
            self._held_jobs = held
            for (_s, job), ring in list(self._rings.items()):
                if job not in held:
                    continue
                while ring.pending():
                    if time.monotonic() >= deadline:
                        raise MetricsTPUUserError(
                            "resize timed out waiting for in-flight rows"
                        )
                    time.sleep(_FORWARD_POLL_S)
            hook("held")
            for shard in range(old_router.num_shards):
                if not self._handles[shard].flush(
                    max(0.1, deadline - time.monotonic())
                ):
                    raise MetricsTPUUserError(
                        f"shard {shard} failed to quiesce for resize"
                    )
            hook("quiesced")
            rows_moved = 0
            for job in sorted(j for j in held if old_router.is_multistream(j)):
                for recipient in range(n):
                    new_lo, new_hi = new_router.span(job, recipient)
                    if recipient < old_router.num_shards and old_router.span(
                        job, recipient
                    ) == (new_lo, new_hi):
                        continue  # span unchanged: nothing to rebuild
                    payloads: List[Dict[str, Any]] = []
                    for donor in range(old_router.num_shards):
                        old_lo, _old_hi = old_router.span(job, donor)
                        lo = max(new_lo, old_lo)
                        hi = min(new_hi, _old_hi)
                        if lo >= hi:
                            continue
                        piece = self._handles[donor].migrate_out(
                            job, lo - old_lo, hi - old_lo
                        )
                        # re-stamp donor-local row coordinates as GLOBAL:
                        # the recipient places pieces by global row
                        payloads.append(dict(piece, lo=int(lo), hi=int(hi)))
                        if donor != recipient:
                            rows_moved += hi - lo
                    handle = staged_handles.get(recipient)
                    if handle is None:
                        handle = self._handles[recipient]
                    handle.migrate_in(
                        job,
                        width=new_hi - new_lo,
                        span_lo=new_lo,
                        pieces=payloads,
                    )
                    staged_imports.append((recipient, handle, job))
            for move in plan.moves:
                if not move.plain:
                    continue
                piece = self._handles[move.donor].migrate_out(move.job)
                handle = staged_handles.get(move.recipient)
                if handle is None:
                    handle = self._handles[move.recipient]
                handle.migrate_in(move.job, pieces=[piece], plain=True)
                staged_imports.append((move.recipient, handle, move.job))
                retire_plain.append((move.donor, move.job))
            hook("staged")
            if n > old_router.num_shards:
                self._handles = list(self._handles) + [
                    staged_handles[s]
                    for s in range(old_router.num_shards, n)
                ]
            self.router = new_router  # THE commit point (atomic store)
            flipped = True
            hook("flipped")
            for _shard, handle, job in staged_imports:
                handle.commit_migration(job)
            hook("committed")
            self._held_jobs = frozenset()
            if self._started:
                for shard in range(old_router.num_shards, n):
                    self._spawn_forwarder(shard)
            hook("released")
            for donor, job in retire_plain:
                if donor < n:
                    self._handles[donor].retire_job(job)
            drained = True
            while any(
                r.depth()
                for (_s, j), r in list(self._rings.items())
                if j in held
            ):
                if time.monotonic() >= deadline:
                    drained = False  # rows are parked, not lost: keep going
                    break
                time.sleep(_FORWARD_POLL_S)
            hook("drained")
            if n < old_router.num_shards:
                if self._retire is not None:
                    for shard in range(n, old_router.num_shards):
                        self._retire(shard)
                self._handles = list(self._handles)[:n]
            _obs.counter_inc("serve.resizes")
            if rows_moved:
                _obs.counter_inc("serve.resize_rows_moved", rows_moved)
            return {
                "epoch": int(new_router.epoch),
                "old_shards": old_router.num_shards,
                "new_shards": n,
                "moves": len(plan.moves),
                "rows_moved": rows_moved,
                "jobs": sorted(held),
                "drained": drained,
                "wall_secs": round(time.monotonic() - t0, 6),
            }
        except BaseException:
            if not flipped:
                # clean abort: exports were pure reads and nothing staged
                # went live — lift the holds, drop staged state, tear down
                # provisioned workers; the old epoch keeps serving
                self._held_jobs = frozenset()
                for _shard, handle, job in staged_imports:
                    try:
                        handle.discard_migration(job)
                    except Exception:  # noqa: BLE001 — the worker may be the casualty
                        pass
                if self._retire is not None:
                    for shard in staged_handles:
                        try:
                            self._retire(shard)
                        except Exception:  # noqa: BLE001
                            pass
            _obs.counter_inc("serve.resize_failures")
            raise
        finally:
            self._resize_done.set()


def _require_width(merged: Any, total: int) -> None:
    """Raise when a merged multistream compute does not cover exactly the
    global stream axis — the signature of a read racing an epoch flip (a
    worker answered with its pre-commit span width); the caller's router
    retry then re-reads against a settled fleet."""
    if isinstance(merged, dict):
        for value in merged.values():
            _require_width(value, total)
        return
    if isinstance(merged, list) and len(merged) != total:
        raise MetricsTPUUserError(
            f"merged stream axis has {len(merged)} row(s), expected {total}"
        )


def _concat_streams(parts: List[Any]) -> Any:
    """Concatenate per-shard jsonable computes along the stream axis.

    Shards return either a list (stacked per-stream values) or a dict of
    such lists (structured computes); spans are contiguous and ascending,
    so plain concatenation in shard order reassembles global stream order.
    """
    if not parts:
        return []
    if isinstance(parts[0], dict):
        return {
            key: _concat_streams([p[key] for p in parts]) for key in parts[0]
        }
    out: List[Any] = []
    for p in parts:
        out.extend(p)
    return out


# --------------------------------------------------------------------------
# HTTP frontend
# --------------------------------------------------------------------------


class FleetHTTPServer(PooledHTTPServer):
    """Pooled HTTP server carrying the owning coordinator reference."""

    def __init__(
        self,
        address: Tuple[str, int],
        coordinator: FleetCoordinator,
        pool_threads: int = 8,
        backlog: int = 64,
    ) -> None:
        super().__init__(
            address, _FleetHandler, pool_threads=pool_threads, backlog=backlog
        )
        self.coordinator = coordinator


def make_fleet_http_server(
    host: str,
    port: int,
    coordinator: FleetCoordinator,
    pool_threads: int = 8,
    backlog: int = 64,
) -> FleetHTTPServer:
    """Bind the coordinator's HTTP frontend; ``port=0`` picks a port."""
    return FleetHTTPServer(
        (host, port), coordinator, pool_threads=pool_threads, backlog=backlog
    )


class _FleetHandler(BaseHTTPRequestHandler):
    """The coordinator's HTTP surface — same routes as a worker, answered
    by scatter-gather instead of local state.

    * ``GET /healthz`` — per-shard liveness rollup; any dead shard is a
      503 (load balancers stop routing a fleet that cannot answer for
      every span).
    * ``GET /metrics`` — the coordinator process's runtime counters
      (``serve.shard_routes``, ``serve.scatter_queries``, ...); metric
      *values* are scraped from the workers, which own the state.
    * ``GET /query`` — ``?job=`` (merged compute), ``&streams=``,
      ``&top_k=``, ``&where=`` — merged exactly as a single worker would
      answer over the union of streams.
    * ``GET /compute_all`` — every job, merged (the failover drill's
      comparison read).
    * ``POST /ingest`` — worker-compatible JSON records, partitioned into
      shard rings (columnar when rows are scalar).
    """

    server_version = "metrics-tpu-fleet/1.0"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt: str, *args: Any) -> None:
        pass

    def _send_json(self, status: int, payload: Dict[str, Any]) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _fail(self, status: int, message: str) -> None:
        _obs.counter_inc("serve.http_errors", status=str(status))
        self._send_json(status, {"error": message})

    def do_GET(self) -> None:  # noqa: N802 (stdlib handler contract)
        url = urlparse(self.path)
        try:
            if url.path == "/healthz":
                self._healthz()
            elif url.path == "/metrics":
                self._metrics()
            elif url.path == "/query":
                self._query(parse_qs(url.query))
            elif url.path == "/compute_all":
                self._compute_all()
            else:
                self._fail(404, f"no route {url.path!r}")
        except MetricsTPUUserError as err:
            self._fail(400, str(err))
        except BrokenPipeError:
            pass
        except Exception as err:  # one bad request must not kill the pool
            self._fail(500, f"{type(err).__name__}: {err}")

    def do_POST(self) -> None:  # noqa: N802
        url = urlparse(self.path)
        try:
            if url.path == "/ingest":
                self._ingest()
            else:
                self._fail(404, f"no route {url.path!r}")
        except MetricsTPUUserError as err:
            self._fail(400, str(err))
        except BrokenPipeError:
            pass
        except Exception as err:
            self._fail(500, f"{type(err).__name__}: {err}")

    # ------------------------------------------------------------ endpoints
    def _healthz(self) -> None:
        coord = self.server.coordinator
        _obs.counter_inc("serve.healthz_requests")
        payload = coord.health()
        self._send_json(200 if payload["status"] == "serving" else 503, payload)

    def _metrics(self) -> None:
        _obs.counter_inc("serve.scrapes")
        text = prometheus_text()
        body = text.encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    @staticmethod
    def _one(params: Dict[str, List[str]], name: str) -> Optional[str]:
        vals = params.get(name)
        return vals[-1] if vals else None

    def _query(self, params: Dict[str, List[str]]) -> None:
        coord = self.server.coordinator
        name = self._one(params, "job")
        if not name:
            raise MetricsTPUUserError("query needs ?job=NAME")
        if name not in coord.router.jobs():
            self._fail(404, f"unknown job {name!r}")
            return
        _obs.counter_inc("serve.queries", job=name)
        key: Any = self._one(params, "key")
        if key is not None and key.lstrip("-").isdigit():
            key = int(key)
        out: Dict[str, Any] = {"job": name}
        streams = self._one(params, "streams")
        top_k = self._one(params, "top_k")
        where = self._one(params, "where")
        if streams is not None:
            ids = [int(s) for s in streams.split(",") if s != ""]
            out["streams"] = ids
            out["values"] = coord.compute_streams(name, ids)
        elif top_k is not None:
            largest = self._one(params, "largest") != "0"
            values, ids = coord.top_k(name, int(top_k), key=key, largest=largest)
            out["top_k"] = values
            out["stream_ids"] = ids
            out["largest"] = largest
        elif where is not None:
            op, _, threshold = where.partition(":")
            k = int(self._one(params, "k") or "16")
            ids, total = coord.where(name, op, float(threshold), k=k, key=key)
            out["stream_ids"] = ids
            out["total_matches"] = total
        else:
            out["value"] = coord.compute(name)
        self._send_json(200, out)

    def _compute_all(self) -> None:
        coord = self.server.coordinator
        _obs.counter_inc("serve.queries", job="__all__")
        self._send_json(200, {"values": coord.compute_all()})

    def _ingest(self) -> None:
        coord = self.server.coordinator
        length = int(self.headers.get("Content-Length") or 0)
        if length <= 0 or length > _MAX_INGEST_BYTES:
            raise MetricsTPUUserError(
                f"ingest needs a JSON body of 1..{_MAX_INGEST_BYTES} bytes"
            )
        try:
            payload = json.loads(self.rfile.read(length).decode())
        except (ValueError, UnicodeDecodeError) as err:
            raise MetricsTPUUserError(f"ingest body is not valid JSON: {err}")
        name = payload.get("job")
        records = payload.get("records")
        if not isinstance(name, str) or not isinstance(records, list):
            raise MetricsTPUUserError(
                'ingest body must be {"job": NAME, "records": [...]}'
            )
        if name not in coord.router.jobs():
            self._fail(404, f"unknown job {name!r}")
            return
        # validate the WHOLE batch before staging any of it (same contract
        # as the worker surface: a malformed record mid-list 400s cleanly)
        parsed: List[Tuple[Tuple[Any, ...], Optional[int]]] = []
        for i, rec in enumerate(records):
            if not isinstance(rec, dict):
                raise MetricsTPUUserError(
                    f"record {i} must be a JSON object, got {type(rec).__name__}"
                )
            values = rec.get("values")
            if not isinstance(values, list) or not values:
                raise MetricsTPUUserError(f'record {i} needs "values": [...]')
            stream_id = rec.get("stream_id")
            if stream_id is not None and (
                isinstance(stream_id, bool) or not isinstance(stream_id, int)
            ):
                raise MetricsTPUUserError(
                    f'record {i} has a non-integer "stream_id": {stream_id!r}'
                )
            parsed.append((tuple(values), stream_id))
        accepted, rejected = coord.ingest_records(name, parsed)
        status = 429 if rejected and not accepted else 200
        self._send_json(status, {"accepted": accepted, "rejected": rejected})
