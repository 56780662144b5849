"""HTTP surface: stdlib ``http.server``, three read endpoints + ingest
(counterpart of ``metrics_tpu/serve/httpd.py``, the same wire).

No new dependencies and **no blocking collectives or KV waits on any
request thread** — the registry's forced ``sync_on_compute=False`` enforces
it, and a read's only wait on the card is its value's own copy to the host.  The
server is a :class:`PooledHTTPServer` — a **bounded** worker pool instead
of ``ThreadingHTTPServer``'s thread-per-connection, so a connection flood
costs a 503 rather than unbounded thread spawn; handlers only ever take a
per-job lock around a local device read, so scrapes and queries stay
responsive while the consumer thread dispatches blocks.

Endpoints:

* ``GET /healthz`` — liveness + queue depth + job inventory (JSON; 503 while
  draining so load balancers stop routing before shutdown).
* ``GET /metrics`` — Prometheus exposition: the runtime counters/spans from
  ``obs.prometheus_text()`` **plus** computed metric values as gauges from
  ``obs.metric_values_prometheus_text(registry)``.
* ``GET /query`` — per-tenant reads: ``?job=NAME`` (full compute),
  ``&streams=1,2,3`` (O(k) per-stream slice), ``&top_k=5[&largest=0]
  [&key=...]`` (device-ranked), ``&where=gt:0.9&k=8`` (device-filtered).
* ``POST /ingest`` — JSON records ``{"job": ..., "records": [{"values":
  [...], "stream_id": ...}, ...]}``; full queues reject with 429.
* ``POST /ingest_columns`` — the fleet's columnar wire: one JSON header
  line, then raw little-endian column bytes; parsed with ``np.frombuffer``
  (no per-record objects) and enqueued as ONE
  :class:`~metrics_tpu_torch.serve.ingest.ColumnBatch`.  The body is read
  once into a writable buffer, so the columns upload to the card without a
  further copy.  Beyond the JAX package's wire, the header may carry
  ``"dtypes"`` (one dtype string per column) and ``"shapes"`` (each
  column's per-row shape, e.g. ``[[1000], []]`` for a row of 1000 logits and
  a label); without them every column is one scalar of ``"dtype"`` a row, as
  in the JAX package.
"""

from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from metrics_tpu_torch.obs import core as _obs
from metrics_tpu_torch.obs.exporters import metric_values_prometheus_text, prometheus_text
from metrics_tpu_torch.serve.registry import _host, _to_jsonable
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

__all__ = ["PooledHTTPServer", "ServeHTTPServer", "make_http_server"]

_MAX_INGEST_BYTES = 8 << 20

_503_RAW = (
    b"HTTP/1.1 503 Service Unavailable\r\n"
    b"Content-Length: 0\r\nConnection: close\r\n\r\n"
)


class PooledHTTPServer(HTTPServer):
    """HTTP server dispatching connections to a bounded worker pool.

    ``ThreadingHTTPServer`` spawns one thread per connection with no upper
    bound — an ingest flood turns into thousands of threads before the
    queue's backpressure ever engages.  Here the accept loop hands each
    connection to a fixed pool through a bounded hand-off queue; when every
    worker is busy and the queue is full the connection gets an immediate
    raw 503 (load balancers retry elsewhere) instead of a growing backlog.

    ``serve.frontend_threads_busy`` counts pool high-water marks: it ticks
    each time the number of simultaneously busy workers reaches a new
    maximum, so a scrape shows the worst concurrency the pool absorbed
    (obs counters are monotone; there are no gauges to sample).
    """

    daemon_threads = True
    allow_reuse_address = True

    def __init__(
        self,
        address: Tuple[str, int],
        handler_cls: Any,
        pool_threads: int = 8,
        backlog: int = 64,
    ) -> None:
        super().__init__(address, handler_cls)
        if int(pool_threads) < 1:
            raise MetricsTPUUserError(
                f"pool_threads must be >= 1, got {pool_threads}"
            )
        self._work_q: "queue.Queue[Tuple[Any, Any]]" = queue.Queue(
            maxsize=max(1, int(backlog))
        )
        self._pool_stop = threading.Event()
        self._busy_lock = threading.Lock()
        try:  # named in the runtime lock-witness graph
            self._busy_lock.witness_name = "PooledHTTPServer._busy_lock"
        except AttributeError:
            pass
        self._busy = 0
        self._busy_high_water = 0
        self._pool = [
            threading.Thread(
                target=self._worker, name=f"http-pool-{i}", daemon=True
            )
            for i in range(int(pool_threads))
        ]
        for t in self._pool:
            t.start()

    # ------------------------------------------------------------ accept side
    def process_request(self, request: Any, client_address: Any) -> None:
        try:
            self._work_q.put_nowait((request, client_address))
        except queue.Full:
            # saturated: fail fast with a raw 503 on the socket — the
            # handler machinery needs a worker we do not have
            _obs.counter_inc("serve.http_pool_rejections")
            try:
                request.sendall(_503_RAW)
            except OSError:
                pass
            self.shutdown_request(request)

    # ------------------------------------------------------------ worker side
    def _note_busy(self, delta: int) -> None:
        with self._busy_lock:
            self._busy += delta
            new_high = self._busy > self._busy_high_water
            if new_high:
                self._busy_high_water = self._busy
        if new_high:
            _obs.counter_inc("serve.frontend_threads_busy")

    def _worker(self) -> None:
        while not self._pool_stop.is_set():
            try:
                request, client_address = self._work_q.get(timeout=0.1)
            except queue.Empty:
                continue
            self._note_busy(1)
            try:
                self.finish_request(request, client_address)
            except Exception:  # noqa: BLE001 — one bad socket must not kill a worker
                self.handle_error(request, client_address)
            finally:
                self.shutdown_request(request)
                self._note_busy(-1)

    def server_close(self) -> None:
        self._pool_stop.set()
        for t in self._pool:
            t.join(timeout=5.0)
        super().server_close()


class ServeHTTPServer(PooledHTTPServer):
    """Pooled HTTP server carrying the owning EvalServer reference."""

    def __init__(
        self,
        address: Tuple[str, int],
        eval_server: Any,
        pool_threads: int = 8,
        backlog: int = 64,
    ) -> None:
        super().__init__(
            address, _Handler, pool_threads=pool_threads, backlog=backlog
        )
        self.eval_server = eval_server


def make_http_server(
    host: str,
    port: int,
    eval_server: Any,
    pool_threads: int = 8,
    backlog: int = 64,
) -> ServeHTTPServer:
    """Bind the serve endpoints; ``port=0`` picks an ephemeral port."""
    return ServeHTTPServer(
        (host, port), eval_server, pool_threads=pool_threads, backlog=backlog
    )


class _Handler(BaseHTTPRequestHandler):
    server_version = "metrics-tpu-serve/1.0"
    protocol_version = "HTTP/1.1"

    # ------------------------------------------------------------- plumbing
    def log_message(self, fmt: str, *args: Any) -> None:
        # request logging is the counters' job, not stderr's
        pass

    def _send(self, status: int, body: bytes, content_type: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, status: int, payload: Dict[str, Any]) -> None:
        self._send(status, json.dumps(payload).encode(), "application/json")

    def _fail(self, status: int, message: str) -> None:
        _obs.counter_inc("serve.http_errors", status=str(status))
        self._send_json(status, {"error": message})

    # ------------------------------------------------------------- routing
    def do_GET(self) -> None:  # noqa: N802 (stdlib handler contract)
        url = urlparse(self.path)
        try:
            if url.path == "/healthz":
                self._healthz()
            elif url.path == "/metrics":
                self._metrics()
            elif url.path == "/query":
                self._query(parse_qs(url.query))
            else:
                self._fail(404, f"no route {url.path!r}")
        except MetricsTPUUserError as err:
            self._fail(400, str(err))
        except BrokenPipeError:
            pass
        except Exception as err:  # one bad request must not kill the thread pool
            self._fail(500, f"{type(err).__name__}: {err}")

    def do_POST(self) -> None:  # noqa: N802
        url = urlparse(self.path)
        try:
            if url.path == "/ingest":
                self._ingest()
            elif url.path == "/ingest_columns":
                self._ingest_columns()
            elif url.path == "/flush":
                self._flush(parse_qs(url.query))
            elif url.path == "/checkpoint":
                self._checkpoint()
            elif url.path == "/migrate_out":
                self._migrate_out()
            elif url.path == "/migrate_in":
                self._migrate_in()
            elif url.path == "/migrate_commit":
                self._migrate_commit()
            elif url.path == "/retire_job":
                self._retire_job()
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
        srv = self.server.eval_server
        _obs.counter_inc("serve.healthz_requests")
        payload = srv.health()
        # anything but "serving" (draining, failed writer) is a 503 so load
        # balancers stop routing to a server that cannot apply records
        self._send_json(200 if payload["status"] == "serving" else 503, payload)

    def _metrics(self) -> None:
        srv = self.server.eval_server
        _obs.counter_inc("serve.scrapes")
        text = prometheus_text() + metric_values_prometheus_text(srv.registry)
        self._send(200, text.encode(), "text/plain; version=0.0.4")

    @staticmethod
    def _one(params: Dict[str, List[str]], name: str) -> Optional[str]:
        vals = params.get(name)
        return vals[-1] if vals else None

    def _query(self, params: Dict[str, List[str]]) -> None:
        srv = self.server.eval_server
        name = self._one(params, "job")
        if not name:
            raise MetricsTPUUserError("query needs ?job=NAME")
        try:
            job = srv.registry[name]
        except KeyError as err:
            self._fail(404, str(err))
            return
        _obs.counter_inc("serve.queries", job=name)
        key: Any = self._one(params, "key")
        if key is not None and key.lstrip("-").isdigit():
            key = int(key)
        out: Dict[str, Any] = {"job": name, "kind": job.kind}
        streams = self._one(params, "streams")
        top_k = self._one(params, "top_k")
        where = self._one(params, "where")
        if streams is not None:
            ids = [int(s) for s in streams.split(",") if s != ""]
            out["streams"] = ids
            out["values"] = _to_jsonable(job.compute_streams(ids))
        elif top_k is not None:
            largest = self._one(params, "largest") != "0"
            values, ids = job.top_k(int(top_k), key=key, largest=largest)
            out["top_k"] = _to_jsonable(values)
            out["stream_ids"] = [int(i) for i in _as_int_list(ids)]
            out["largest"] = largest
        elif where is not None:
            op, _, threshold = where.partition(":")
            k = int(self._one(params, "k") or "16")
            ids, total = job.where_op(op, float(threshold), k=k, key=key)
            out["stream_ids"] = [i for i in _as_int_list(ids) if i >= 0]
            out["total_matches"] = int(_scalar(total))
        else:
            out["value"] = _to_jsonable(job.compute())
        self._send_json(200, out)

    def _ingest(self) -> None:
        srv = self.server.eval_server
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
        if name not in srv.registry:
            self._fail(404, f"unknown job {name!r}")
            return
        # validate the WHOLE batch before enqueuing any of it: a malformed
        # record mid-list must 400 with nothing accepted, not after earlier
        # records already landed with no accounting of which ones
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
        accepted = rejected = 0
        for values, stream_id in parsed:
            ok = srv.submit(name, values, stream_id=stream_id)
            accepted += int(ok)
            rejected += int(not ok)
        status = 429 if rejected and not accepted else 200
        self._send_json(status, {"accepted": accepted, "rejected": rejected})

    def _ingest_columns(self) -> None:
        """Columnar wire: ``<json header>\\n<raw column bytes>``.

        The header is ``{"job": NAME, "rows": n, "arity": k,
        "dtype": "<f4", "ids": bool}``; the payload is ``arity``
        column blobs of ``n`` rows each, then (when ``ids``) one int32
        blob of ``n`` stream ids.  Columns become ``np.frombuffer`` views
        over the request body — no per-record Python objects anywhere on
        this path — and enqueue as ONE ColumnBatch (one queue slot).

        An optional ``"seqs": [[seq_or_null, rows], ...]`` header field
        partitions the rows into WAL frames (they must sum to ``rows``):
        the server then seq-dedups per frame, so duplicated forwards —
        a coordinator POST retry, or a failover replay racing parked rows
        — land exactly once (a deduped frame still counts as accepted:
        idempotent success, not rejection).
        """
        import numpy as np

        srv = self.server.eval_server
        length = int(self.headers.get("Content-Length") or 0)
        if length <= 0 or length > _MAX_INGEST_BYTES:
            raise MetricsTPUUserError(
                f"ingest_columns needs a body of 1..{_MAX_INGEST_BYTES} bytes"
            )
        body = _read_body(self.rfile, length)
        nl = body.find(b"\n")
        if nl < 0:
            raise MetricsTPUUserError(
                "ingest_columns body needs a JSON header line"
            )
        try:
            header = json.loads(body[:nl].decode())
        except (ValueError, UnicodeDecodeError) as err:
            raise MetricsTPUUserError(f"bad ingest_columns header: {err}")
        name = header.get("job")
        rows = header.get("rows")
        arity = header.get("arity")
        if (
            not isinstance(name, str)
            or not isinstance(rows, int)
            or not isinstance(arity, int)
            or isinstance(rows, bool)
            or isinstance(arity, bool)
            or rows < 1
            or arity < 1
        ):
            raise MetricsTPUUserError(
                'ingest_columns header needs {"job", "rows" >= 1, "arity" >= 1}'
            )
        if name not in srv.registry:
            self._fail(404, f"unknown job {name!r}")
            return
        dtypes, shapes = _column_layout(header, arity)
        with_ids = bool(header.get("ids", False))
        sizes = [int(np.prod(shape, dtype=np.int64)) for shape in shapes]
        need = nl + 1 + sum(
            rows * size * dt.itemsize for size, dt in zip(sizes, dtypes)
        ) + (rows * 4 if with_ids else 0)
        if need != length:
            raise MetricsTPUUserError(
                f"ingest_columns header declares {need} bytes, body has {length}"
            )
        offset = nl + 1
        cols = []
        for dt, shape, size in zip(dtypes, shapes, sizes):
            col = np.frombuffer(body, dtype=dt, count=rows * size, offset=offset)
            cols.append(col.reshape((rows,) + shape))
            offset += rows * size * dt.itemsize
        stream_ids = (
            np.frombuffer(body, dtype="<i4", count=rows, offset=offset)
            if with_ids
            else None
        )
        seqs = header.get("seqs")
        if seqs is not None:
            if not isinstance(seqs, list) or not all(
                isinstance(s, list)
                and len(s) == 2
                and (s[0] is None or isinstance(s[0], int))
                and isinstance(s[1], int)
                and not isinstance(s[1], bool)
                and s[1] >= 1
                for s in seqs
            ):
                raise MetricsTPUUserError(
                    'ingest_columns "seqs" must be [[seq_or_null, rows>=1], ...]'
                )
            if sum(s[1] for s in seqs) != rows:
                raise MetricsTPUUserError(
                    'ingest_columns "seqs" row counts must sum to "rows"'
                )
            seqs = [(s[0], s[1]) for s in seqs]
        ok = srv.submit_columns(name, tuple(cols), stream_ids=stream_ids, seqs=seqs)
        _obs.counter_inc("serve.column_batches", job=name)
        status = 200 if ok else 429
        self._send_json(
            status,
            {"accepted": rows if ok else 0, "rejected": 0 if ok else rows},
        )

    def _flush(self, params: Dict[str, List[str]]) -> None:
        """Drain the ingest queue + dispatch all staged rows (fleet drills
        call this on each shard before a coordinated read or checkpoint)."""
        srv = self.server.eval_server
        timeout = float(self._one(params, "timeout") or "10.0")
        ok = srv.flush(timeout=timeout)
        self._send_json(200 if ok else 504, {"flushed": bool(ok)})

    def _checkpoint(self) -> None:
        """Operator-triggered durable snapshot (the coordinator's failover
        drill checkpoints a shard before killing it).  ``wal_marks`` in the
        response are the applied-seq watermarks the commit recorded — the
        fleet truncates WAL segments they cover."""
        srv = self.server.eval_server
        step = srv.checkpoint_now()
        out: Dict[str, Any] = {"step": int(step)}
        marks = getattr(srv, "last_checkpoint_wal_marks", None)
        if marks is not None:
            out["wal_marks"] = dict(marks)
        self._send_json(200, out)

    # ------------------------------------------------- elastic resize wire
    def _json_body(self) -> Dict[str, Any]:
        length = int(self.headers.get("Content-Length") or 0)
        if length <= 0 or length > _MAX_INGEST_BYTES:
            raise MetricsTPUUserError(
                f"endpoint needs a JSON body of 1..{_MAX_INGEST_BYTES} bytes"
            )
        try:
            payload = json.loads(self.rfile.read(length).decode())
        except (ValueError, UnicodeDecodeError) as err:
            raise MetricsTPUUserError(f"body is not valid JSON: {err}")
        if not isinstance(payload, dict) or not isinstance(payload.get("job"), str):
            raise MetricsTPUUserError('body must be a JSON object with "job"')
        return payload

    def _migrate_out(self) -> None:
        """Export migrating state for one job (coordinator resize, donor
        side): a pure read — the donor keeps serving from its live state."""
        srv = self.server.eval_server
        payload = self._json_body()
        out = srv.export_span(
            payload["job"], lo=payload.get("lo"), hi=payload.get("hi")
        )
        _obs.counter_inc("serve.migrate_out_requests", job=payload["job"])
        self._send_json(200, out)

    def _migrate_in(self) -> None:
        """Stage a job's post-resize metric from donor pieces (recipient
        side).  Nothing goes live until ``/migrate_commit``."""
        srv = self.server.eval_server
        payload = self._json_body()
        pieces = payload.get("pieces")
        if not isinstance(pieces, list) or not pieces:
            raise MetricsTPUUserError('migrate_in needs "pieces": [...]')
        adopted = srv.import_span(
            payload["job"],
            width=payload.get("width"),
            span_lo=int(payload.get("span_lo", 0)),
            pieces=tuple(pieces),
            plain=bool(payload.get("plain", False)),
        )
        self._send_json(200, {"job": payload["job"], "adopted": int(adopted)})

    def _migrate_commit(self) -> None:
        """Flip one job to its staged post-resize metric — or, with
        ``"discard": true``, drop staged state (the coordinator's abort)."""
        srv = self.server.eval_server
        payload = self._json_body()
        if payload.get("discard"):
            dropped = srv.discard_migration(payload["job"])
            self._send_json(200, {"job": payload["job"], "discarded": dropped})
            return
        srv.commit_migration(payload["job"])
        self._send_json(200, {"job": payload["job"], "committed": True})

    def _retire_job(self) -> None:
        """Drop a job whose state migrated away (plain-job donor)."""
        srv = self.server.eval_server
        payload = self._json_body()
        srv.retire_job(payload["job"])
        self._send_json(200, {"job": payload["job"], "retired": True})


def _read_body(rfile: Any, length: int) -> bytearray:
    """The request body in one writable buffer (one copy off the socket), so
    ``np.frombuffer`` views of it can go to ``torch.from_numpy`` as they are."""
    body = bytearray(length)
    view = memoryview(body)
    got = 0
    while got < length:
        n = rfile.readinto(view[got:])
        if not n:
            raise MetricsTPUUserError(f"body ended after {got} of {length} bytes")
        got += n
    return body


def _column_layout(header: Dict[str, Any], arity: int) -> Tuple[List[Any], List[Tuple[int, ...]]]:
    """Each column's dtype and per-row shape from an ``/ingest_columns`` header."""
    import numpy as np

    dtypes = header.get("dtypes")
    if dtypes is None:
        dtypes = [header.get("dtype", "<f4")] * arity
    shapes = header.get("shapes")
    if shapes is None:
        shapes = [[]] * arity
    if (
        not isinstance(dtypes, list)
        or not isinstance(shapes, list)
        or len(dtypes) != arity
        or len(shapes) != arity
        or not all(
            isinstance(sh, list)
            and all(isinstance(d, int) and not isinstance(d, bool) and d >= 1 for d in sh)
            for sh in shapes
        )
    ):
        raise MetricsTPUUserError(
            'ingest_columns "dtypes" and "shapes" need one entry per column '
            "(a dtype string; a list of positive dims)"
        )
    try:
        dts = [np.dtype(d) for d in dtypes]
    except TypeError as err:
        raise MetricsTPUUserError(f"bad ingest_columns dtype: {err}")
    return dts, [tuple(sh) for sh in shapes]


def _as_int_list(arr: Any) -> List[int]:
    return [int(v) for v in _host(arr).reshape(-1)]


def _scalar(value: Any) -> float:
    return float(_host(value))
