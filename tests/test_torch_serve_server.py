"""The port's ``EvalServer`` and HTTP surface (``metrics_tpu_torch.serve.{server,httpd}``) on the CPU.

Mirrors ``tests/serve/test_server.py`` case for case with ``device="cpu"``,
its slow-tier mini drill (the soak harness in miniature) included.
``test_restore_on_start`` is held to what the JAX test asserts: the restored
mean squared error bitwise that of one direct update over the same rows.
Then the port against the JAX package: the same HTTP traffic into both
packages' servers gives equal ``/query`` JSON and value gauges (inputs are
multiples of 1/8), and a server checkpoint written by either package
restores into the other's server.  Last, the port's own pieces: the
columnar wire's ``dtypes``/``shapes`` extension, and the span export,
import and commit that the fleet drives, as a round trip.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu_torch as T
from metrics_tpu.checkpoint import CheckpointManager as JManager
from metrics_tpu.serve import EvalServer as JServer
from metrics_tpu.serve import MetricRegistry as JRegistry
from metrics_tpu.serve import ServeConfig as JConfig
from metrics_tpu_torch import obs
from metrics_tpu_torch.checkpoint import CheckpointManager
from metrics_tpu_torch.checkpoint.store import LocalStore
from metrics_tpu_torch.multistream import MultiStreamMetric
from metrics_tpu_torch.obs import parse_prometheus_text
from metrics_tpu_torch.regression import MeanSquaredError
from metrics_tpu_torch.serve import EvalServer, MetricRegistry, ServeConfig
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

S = 8
CPU = {"device": "cpu"}


def _registry():
    reg = MetricRegistry()
    reg.register("mse", MeanSquaredError(**CPU))
    reg.register("tenants", MultiStreamMetric(MeanSquaredError(**CPU), num_streams=S, **CPU), export_top_k=2)
    return reg


def _config(**kw):
    kw.setdefault("block_rows", 16)
    kw.setdefault("flush_interval", 3600.0)  # flushes in tests are explicit
    return ServeConfig(**kw)


def _get(port, path, expect=200):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10.0) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as err:
        assert err.code == expect, f"{path}: HTTP {err.code}: {err.read()!r}"
        return err.code, err.read()


def _get_json(port, path, expect=200):
    status, body = _get(port, path, expect=expect)
    assert status == expect, f"{path}: HTTP {status}: {body!r}"
    return json.loads(body)


def _post(port, path, data, content_type="application/json"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, headers={"Content-Type": content_type}, method="POST"
    )
    try:
        with urllib.request.urlopen(req, timeout=10.0) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _post_json(port, path, payload):
    return _post(port, path, json.dumps(payload).encode())


@pytest.fixture
def server():
    srv = EvalServer(_registry(), _config()).start()
    yield srv
    if not srv._stopped:
        srv.kill()


def _feed(srv, n=10, seed=0):
    rng = np.random.default_rng(seed)
    preds = rng.uniform(size=n).astype(np.float32)
    target = rng.uniform(size=n).astype(np.float32)
    for p, t in zip(preds, target):
        assert srv.submit("mse", (p, t), timeout=5.0)
        assert srv.submit("tenants", (p, t), stream_id=int(rng.integers(0, S)), timeout=5.0)
    assert srv.flush()
    return preds, target


class TestHTTPSurface:
    def test_healthz(self, server):
        _feed(server, n=5)
        payload = _get_json(server.port, "/healthz")
        assert payload["status"] == "serving"
        assert payload["records_ingested"] == 10
        assert {j["job"] for j in payload["jobs"]} == {"mse", "tenants"}
        assert payload["last_checkpoint_step"] is None

    def test_metrics_exposes_counters_and_value_gauges(self, server):
        _feed(server, n=5)
        status, body = _get(server.port, "/metrics")
        assert status == 200
        parsed = parse_prometheus_text(body.decode())
        assert parsed[("metrics_tpu_serve_records_ingested_total", ())] >= 10
        gauge_jobs = {dict(labels).get("job") for (name, labels) in parsed if name == "metrics_tpu_metric_value"}
        assert {"mse", "tenants"} <= gauge_jobs

    def test_query_plain_and_multistream(self, server):
        preds, target = _feed(server, n=8)
        direct = MeanSquaredError(**CPU)
        direct.update(preds, target)
        out = _get_json(server.port, "/query?job=mse")
        assert out["kind"] == "plain"
        assert out["value"] == pytest.approx(float(direct.compute()), rel=1e-6)

        streams = _get_json(server.port, "/query?job=tenants&streams=0,1")
        assert streams["streams"] == [0, 1] and len(streams["values"]) == 2

        top = _get_json(server.port, "/query?job=tenants&top_k=2")
        assert len(top["top_k"]) == 2 and len(top["stream_ids"]) == 2

        hits = _get_json(server.port, "/query?job=tenants&where=ge:0.0&k=8")
        assert hits["total_matches"] >= 1

    def test_query_errors(self, server):
        _get_json(server.port, "/query", expect=400)
        _get_json(server.port, "/query?job=nope", expect=404)
        _get_json(server.port, "/query?job=mse&top_k=2", expect=400)
        _get_json(server.port, "/nosuch", expect=404)

    def test_ingest_post_roundtrip(self, server):
        status, out = _post_json(
            server.port, "/ingest", {"job": "mse", "records": [{"values": [1.0, 0.0]}, {"values": [0.0, 0.0]}]}
        )
        assert status == 200 and out == {"accepted": 2, "rejected": 0}
        assert server.flush()
        got = _get_json(server.port, "/query?job=mse")
        assert got["value"] == pytest.approx(0.5)

    def test_ingest_post_validation(self, server):
        status, out = _post_json(server.port, "/ingest", {"job": "nope", "records": []})
        assert status == 404
        status, out = _post_json(server.port, "/ingest", {"records": "x"})
        assert status == 400 and "error" in out

    def test_ingest_post_is_atomic_on_malformed_batches(self, server):
        status, out = _post_json(
            server.port, "/ingest", {"job": "mse", "records": [{"values": [1.0, 0.0]}, {"values": "x"}]}
        )
        assert status == 400 and "record 1" in out["error"]
        status, out = _post_json(server.port, "/ingest", {"job": "mse", "records": [42]})
        assert status == 400 and "record 0" in out["error"]
        status, out = _post_json(
            server.port, "/ingest", {"job": "tenants", "records": [{"values": [1.0, 0.0], "stream_id": "x"}]}
        )
        assert status == 400 and "stream_id" in out["error"]
        assert server.queue.depth() == 0  # nothing partially enqueued


class TestWriterFailure:
    def test_healthz_flips_to_failed_when_writer_dies(self, server):
        server.consumer.kill.set()
        server._threads["consumer"].join(timeout=10.0)
        payload = server.health()
        assert payload["status"] == "failed"
        assert payload["consumer_alive"] is False
        _get_json(server.port, "/healthz", expect=503)

    def test_flush_times_out_instead_of_hanging(self):
        srv = EvalServer(_registry(), _config(queue_capacity=2)).start()
        try:
            srv.consumer.kill.set()
            real = srv._threads["consumer"]
            real.join(timeout=10.0)

            class _Stuck:
                def is_alive(self):
                    return True

                def join(self, timeout=None):
                    pass

            srv._threads["consumer"] = _Stuck()
            assert srv.submit("mse", (1.0, 2.0))
            assert srv.submit("mse", (1.0, 2.0))  # queue now full
            t0 = time.monotonic()
            assert srv.flush(timeout=0.6) is False
            assert time.monotonic() - t0 < 5.0
            srv._threads["consumer"] = real
        finally:
            srv.kill()


class TestLifecycle:
    def test_start_twice_raises(self, server):
        with pytest.raises(MetricsTPUUserError, match="twice"):
            server.start()

    def test_restore_on_start(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), rank=0, world_size=1)
        srv = EvalServer(_registry(), _config(), mgr).start()
        try:
            preds, target = _feed(srv, n=6, seed=3)
            step = srv.checkpoint_now()
        finally:
            srv.kill()

        mgr2 = CheckpointManager(str(tmp_path), rank=0, world_size=1)
        srv2 = EvalServer(_registry(), _config(), mgr2).start()
        try:
            assert srv2.restored_step == step
            direct = MeanSquaredError(**CPU)
            direct.update(preds, target)
            got = np.asarray(srv2.registry["mse"].compute())
            assert np.all(
                got.astype(np.float64).view(np.uint64) == np.asarray(direct.compute(), np.float64).view(np.uint64)
            )
            health = _get_json(srv2.port, "/healthz")
            assert health["restored_step"] == step
        finally:
            srv2.kill()

    def test_drain_stop_flushes_and_checkpoints(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), rank=0, world_size=1)
        srv = EvalServer(_registry(), _config(), mgr).start()
        assert srv.submit("mse", (np.float32(1.0), np.float32(0.0)), timeout=5.0)
        final = srv.stop(final_checkpoint=True)
        assert final is not None
        assert srv.submit("mse", (1.0, 0.0)) is False  # draining rejects

        mgr2 = CheckpointManager(str(tmp_path), rank=0, world_size=1)
        reg2 = _registry()
        result = mgr2.restore(reg2.checkpoint_target(), step=final)
        assert result.step == final
        assert float(reg2["mse"].compute()) == pytest.approx(1.0)

    def test_kill_skips_final_checkpoint(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), rank=0, world_size=1)
        srv = EvalServer(_registry(), _config(), mgr).start()
        assert srv.submit("mse", (np.float32(1.0), np.float32(0.0)), timeout=5.0)
        srv.kill()
        assert mgr.latest_step() is None

    def test_durability_loop_max_staleness(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), rank=0, world_size=1, max_staleness=0.2)
        srv = EvalServer(_registry(), _config(durability_poll=0.05), mgr).start()
        try:
            _feed(srv, n=3, seed=5)
            deadline = time.monotonic() + 10.0
            while srv.last_checkpoint_step is None:
                assert time.monotonic() < deadline, "durability loop never checkpointed"
                time.sleep(0.05)
            assert mgr.latest_step() is not None
        finally:
            srv.stop(final_checkpoint=False)


class TestNonBlockingSnapshots:
    def test_query_p99_flat_while_snapshot_in_flight(self, tmp_path):
        """A slow store must not surface in ``/query`` latency: the encode holds
        one brief per-job lock per metric, the store writes and the commit hold
        none, so read p99 stays under one store write while the checkpoint crawls."""

        class SlowStore(LocalStore):
            write_delay = 0.15

            def write_atomic(self, path, data):
                time.sleep(self.write_delay)
                super().write_atomic(path, data)

        mgr = CheckpointManager(store=SlowStore(str(tmp_path)), rank=0, world_size=1)
        srv = EvalServer(_registry(), _config(), mgr).start()
        try:
            _feed(srv, n=8, seed=11)
            _get_json(srv.port, "/query?job=mse")  # warm the compute path

            done = threading.Event()
            committed = []

            def snapshot():
                t0 = time.monotonic()
                committed.append((srv.checkpoint_now(), time.monotonic() - t0))
                done.set()

            before = obs.summarize_counters().get("serve", {})
            t = threading.Thread(target=snapshot)
            t.start()
            latencies = []
            while not done.is_set():
                t0 = time.monotonic()
                out = _get_json(srv.port, "/query?job=mse")
                latencies.append(time.monotonic() - t0)
                assert out["kind"] == "plain"
            t.join(timeout=30.0)

            step, snap_secs = committed[0]
            assert step is not None
            assert snap_secs >= 2 * SlowStore.write_delay, snap_secs
            assert len(latencies) >= 5, "queries did not overlap the snapshot"
            p99 = float(np.quantile(latencies, 0.99))
            assert p99 < SlowStore.write_delay, f"/query p99 {p99:.3f}s spiked"
            after = obs.summarize_counters().get("serve", {})
            assert after.get("nonblocking_snapshots", 0) > before.get("nonblocking_snapshots", 0)
        finally:
            srv.kill()


# ---------------------------------------------------------------------------
# the port against the JAX package: one traffic, two servers
# ---------------------------------------------------------------------------


def _pair_registry(pkg):
    reg, kw = (JRegistry(), {}) if pkg is J else (MetricRegistry(), CPU)
    reg.register("mse", pkg.MeanSquaredError(**kw))
    reg.register("tenants", pkg.MultiStreamMetric(pkg.MeanSquaredError(**kw), num_streams=S, **kw), export_top_k=3)
    reg.register("acc", pkg.Accuracy(num_classes=4, **kw))
    return reg


def _pair_server(pkg, directory=None):
    manager_cls, server_cls, config_cls = (JManager, JServer, JConfig) if pkg is J else (CheckpointManager, EvalServer, ServeConfig)
    manager = None if directory is None else manager_cls(str(directory), rank=0, world_size=1)
    return server_cls(_pair_registry(pkg), config_cls(block_rows=16, flush_interval=3600.0), manager).start()


def _pair_traffic(port, seed):
    """JSON records and columnar bodies of multiples of 1/8 (out-of-range stream ids included)."""
    rng = np.random.default_rng(seed)
    for _ in range(3):
        n = int(rng.integers(5, 40))
        p = (rng.integers(0, 64, n) / 8).astype(np.float32)
        t = (rng.integers(0, 64, n) / 8).astype(np.float32)
        ids = rng.integers(-1, S + 2, n).astype(np.int32)
        records = [{"values": [float(a), float(b)]} for a, b in zip(p, t)]
        assert _post_json(port, "/ingest", {"job": "mse", "records": records})[0] == 200
        tenants = [{"values": [float(a), float(b)], "stream_id": int(i)} for a, b, i in zip(p, t, ids)]
        assert _post_json(port, "/ingest", {"job": "tenants", "records": tenants})[0] == 200
        header = json.dumps({"job": "tenants", "rows": n, "arity": 2, "dtype": "<f4", "ids": True}).encode()
        assert _post(port, "/ingest_columns", header + b"\n" + p.tobytes() + t.tobytes() + ids.tobytes())[0] == 200
        header = json.dumps({"job": "mse", "rows": n, "arity": 2, "dtype": "<f4"}).encode()
        assert _post(port, "/ingest_columns", header + b"\n" + t.tobytes() + p.tobytes())[0] == 200
        logits = rng.integers(-16, 16, (n, 4)) / 8
        labels = rng.integers(0, 4, n)
        acc = [{"values": [row.tolist(), int(y)]} for row, y in zip(logits, labels)]
        assert _post_json(port, "/ingest", {"job": "acc", "records": acc})[0] == 200


QUERIES = (
    "/query?job=mse",
    "/query?job=acc",
    "/query?job=tenants",
    "/query?job=tenants&streams=0,3,7",
    "/query?job=tenants&top_k=4",
    "/query?job=tenants&top_k=3&largest=0",
    "/query?job=tenants&where=gt:9.5&k=5",
    "/query?job=tenants&where=le:9.5&k=2",
)


@pytest.fixture(scope="module")
def served_pair(tmp_path_factory):
    """One JAX and one port server, each fed the same traffic over HTTP and flushed."""
    root = tmp_path_factory.mktemp("pair")
    servers = {pkg: _pair_server(pkg, root / ("jax" if pkg is J else "torch")) for pkg in (J, T)}
    try:
        for srv in servers.values():
            _pair_traffic(srv.port, seed=21)
            assert srv.flush(10.0)
        yield servers, root
    finally:
        for srv in servers.values():
            srv.kill()


class TestMiniDrill:
    @pytest.mark.slow
    def test_kill_restore_recovers_bit_identical(self, tmp_path):
        """Miniature of the soak drill: checkpoint, lose a tail, kill,
        restore, replay: byte for byte equal to never having died.  Slow
        tier, as in the JAX package."""
        from metrics_tpu_torch.serve.soak import run_drill

        result = run_drill(
            str(tmp_path),
            n=180,
            k=100,
            lost_tail=7,
            block_rows=16,
            num_streams=8,
            store_faults=[],
            poll=False,
            device="cpu",
        )
        assert result.identical, {"baseline": result.baseline, "recovered": result.recovered}
        assert result.restored_step == result.checkpoint_step
        assert result.checkpoint_failures == 0


def _value_gauges(port):
    parsed = parse_prometheus_text(_get(port, "/metrics")[1].decode())
    return {key: value for key, value in parsed.items() if key[0] == "metrics_tpu_metric_value"}


class TestParityWithJax:
    @pytest.mark.parametrize("path", QUERIES)
    def test_query_json_equals_the_jax_servers(self, served_pair, path):
        servers, _ = served_pair
        assert _get_json(servers[T].port, path) == _get_json(servers[J].port, path)

    def test_value_gauges_and_inventory_equal_the_jax_servers(self, served_pair):
        servers, _ = served_pair
        assert _value_gauges(servers[T].port) == _value_gauges(servers[J].port)
        jh, th = _get_json(servers[J].port, "/healthz"), _get_json(servers[T].port, "/healthz")
        assert th["jobs"] == jh["jobs"] and th["records_ingested"] == jh["records_ingested"]

    @pytest.mark.parametrize("writer", ["jax", "torch"])
    def test_a_server_checkpoint_restores_into_the_other_package(self, served_pair, writer):
        servers, root = served_pair
        src, dst = (J, T) if writer == "jax" else (T, J)
        step = servers[src].checkpoint_now()
        restored = _pair_server(dst, root / writer)
        try:
            assert restored.restored_step == step
            got, want = restored.registry.compute_all(), servers[src].registry.compute_all()
            for name in want:
                assert np.asarray(got[name], np.float64).tobytes() == np.asarray(want[name], np.float64).tobytes(), name
            for path in QUERIES:
                assert _get_json(restored.port, path) == _get_json(servers[src].port, path)
        finally:
            restored.kill()


# ---------------------------------------------------------------------------
# the port's own pieces
# ---------------------------------------------------------------------------


class TestColumnarShapes:
    def test_rows_of_logits_beside_int64_labels(self, server):
        server.registry.register("acc", T.Accuracy(num_classes=5, **CPU))
        rng = np.random.default_rng(9)
        logits = rng.standard_normal((37, 5)).astype(np.float32)
        labels = rng.integers(0, 5, 37)
        header = {"job": "acc", "rows": 37, "arity": 2, "dtypes": ["<f4", "<i8"], "shapes": [[5], []]}
        body = json.dumps(header).encode() + b"\n" + logits.tobytes() + labels.astype("<i8").tobytes()
        assert _post(server.port, "/ingest_columns", body) == (200, {"accepted": 37, "rejected": 0})
        assert server.flush()
        direct = T.Accuracy(num_classes=5, **CPU)
        for lo, hi in ((0, 32), (32, 36), (36, 37)):  # the pieces of a 37-row flush at block_rows 16: 16+16+4+1
            direct.update(torch.from_numpy(logits[lo:hi]), torch.from_numpy(labels[lo:hi]))
        assert _get_json(server.port, "/query?job=acc")["value"] == float(direct.compute())

    def test_layout_errors_are_400(self, server):
        header = {"job": "mse", "rows": 2, "arity": 2, "dtypes": ["<f4"], "shapes": [[], []]}
        status, out = _post(server.port, "/ingest_columns", json.dumps(header).encode() + b"\n" + bytes(16))
        assert status == 400 and "one entry per column" in out["error"]
        header = json.dumps({"job": "mse", "rows": 2, "arity": 2, "dtypes": ["<f4", "<f4"], "shapes": [[3], []]})
        status, out = _post(server.port, "/ingest_columns", header.encode() + b"\n" + bytes(16))
        # two rows of (3,) float32 and two scalars: 32 payload bytes declared, 16 sent
        assert status == 400 and f"declares {len(header) + 1 + 32} bytes" in out["error"]


class _Spec:
    def __init__(self, make):
        self.build = make
        self.components = None
        self.export_top_k = 0


class TestMigration:
    def test_span_and_plain_job_round_trip(self):
        donor = EvalServer(_registry(), _config()).start()
        builders = {"tenants": _Spec(lambda: MeanSquaredError(**CPU)), "mse": _Spec(lambda: MeanSquaredError(**CPU))}
        reg = MetricRegistry()
        reg.register("tenants", MultiStreamMetric(MeanSquaredError(**CPU), num_streams=4, **CPU))
        recipient = EvalServer(reg, _config(), builders=builders).start()
        try:
            _feed(donor, n=40, seed=2)
            rows = donor.registry["tenants"].metric.stream_slice(2, 6)
            status, piece = _post_json(donor.port, "/migrate_out", {"job": "tenants", "lo": 2, "hi": 6})
            assert status == 200
            status, out = _post_json(
                recipient.port, "/migrate_in", {"job": "tenants", "width": 4, "span_lo": 2, "pieces": [piece]}
            )
            assert (status, out["adopted"]) == (200, 4)
            assert recipient.registry["tenants"].metric.stream_rows.tolist() == [0, 0, 0, 0]  # staged, not live
            assert _post_json(recipient.port, "/migrate_commit", {"job": "tenants"})[1]["committed"] is True
            live = recipient.registry["tenants"].metric
            for key, value in rows.items():
                assert getattr(live, key).numpy().tobytes() == value.numpy().tobytes(), key
            # a plain job moves whole: export, stage, commit registers it
            plain = donor.export_span("mse")
            assert recipient.import_span("mse", pieces=(plain,), plain=True) == 1
            assert recipient.discard_migration("nope") == 0
            recipient.commit_migration("mse")
            assert float(recipient.registry["mse"].compute()) == float(donor.registry["mse"].compute())
            assert _post_json(donor.port, "/retire_job", {"job": "mse"})[1]["retired"] is True
            assert "mse" not in donor.registry
            with pytest.raises(MetricsTPUUserError, match="no staged migration"):
                recipient.commit_migration("tenants")
            with pytest.raises(MetricsTPUUserError, match="no builder"):
                donor.import_span("tenants", width=4, pieces=(piece,))
        finally:
            donor.kill()
            recipient.kill()
