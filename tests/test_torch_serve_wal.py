"""The port's write-ahead log (``metrics_tpu_torch.serve.wal``) and exactly-once ingest, on the CPU.

Mirrors ``tests/serve/test_wal.py`` case for case with ``device="cpu"``:
the codec, group commit, rotation and recovery, the injected faults (each
pinned to one recovery policy), checkpoint watermarks, and the server's
seq dedup, in process and over HTTP (there through the JAX package's own
``HTTPShard`` client, so the wire is the JAX one).  Its fleet cases
(``TestFleetWal``) need the sharded fleet, which is not ported yet.

Then the port against the JAX package: frames byte-equal for the same
batch, a log written by either package replays in the other with the same
frames, torn tails and damaged segments recovered alike, and the port's
shaped frames (several dtypes, per-row shapes) round-trip in the port while
the JAX reader refuses them.  Inputs are multiples of 1/8, so float sums
are exact in any order and "identical" means bitwise.
"""

import threading

import numpy as np
import pytest

from metrics_tpu.serve import HTTPShard
from metrics_tpu.serve import wal as jwal
from metrics_tpu_torch.checkpoint import CheckpointManager
from metrics_tpu_torch.multistream import MultiStreamMetric
from metrics_tpu_torch.obs import counter_value, parse_prometheus_text, prometheus_text, summarize_counters
from metrics_tpu_torch.regression import MeanSquaredError
from metrics_tpu_torch.serve import (
    EvalServer,
    MetricRegistry,
    ServeConfig,
    WalCorruption,
    WalWriter,
    inject_wal_fault,
    replay_frames,
)
from metrics_tpu_torch.serve.wal import decode_frame, encode_frame, list_segments, read_segment_frames
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

S = 16
BLOCK = 8
CPU = {"device": "cpu"}


def _cols(rng, n):
    # dyadic rationals: float32-exact under any accumulation order
    return [
        (rng.integers(0, 64, n) / 8.0).astype(np.float32),
        (rng.integers(0, 64, n) / 8.0).astype(np.float32),
    ]


def trees_bitwise_equal(a, b):
    """Two computed values (tensors, arrays, dicts of them) equal bit for bit."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(trees_bitwise_equal(a[k], b[k]) for k in a)
    return np.asarray(a).dtype == np.asarray(b).dtype and np.asarray(a).tobytes() == np.asarray(b).tobytes()


# ---------------------------------------------------------------------------
# frame codec
# ---------------------------------------------------------------------------


class TestCodec:
    def test_round_trip_with_ids(self):
        rng = np.random.default_rng(0)
        cols = _cols(rng, 9)
        ids = rng.integers(0, S, 9).astype(np.int32)
        buf = encode_frame("tenants", 42, cols, ids)
        frame, nxt = decode_frame(buf)
        assert nxt == len(buf)
        assert frame.job == "tenants" and frame.seq == 42 and frame.rows == 9
        for got, want in zip(frame.cols, cols):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(frame.stream_ids, ids)

    def test_round_trip_plain(self):
        buf = encode_frame("mse", 0, [np.ones(3, np.float32)])
        frame, _ = decode_frame(buf)
        assert frame.stream_ids is None and frame.rows == 3

    def test_frames_self_delimit(self):
        a = encode_frame("a", 0, [np.ones(2, np.float32)])
        b = encode_frame("b", 1, [np.zeros(5, np.float32)])
        fa, off = decode_frame(a + b)
        fb, end = decode_frame(a + b, off)
        assert (fa.job, fb.job) == ("a", "b") and end == len(a + b)

    def test_crc_mismatch_raises(self):
        buf = bytearray(encode_frame("a", 0, [np.ones(4, np.float32)]))
        buf[12] ^= 0x01
        with pytest.raises(WalCorruption, match="crc"):
            decode_frame(bytes(buf))

    def test_torn_buffer_raises(self):
        buf = encode_frame("a", 0, [np.ones(4, np.float32)])
        with pytest.raises(WalCorruption, match="torn"):
            decode_frame(buf[:-3])

    def test_validation(self):
        with pytest.raises(MetricsTPUUserError, match="ragged"):
            encode_frame("a", 0, [np.ones(2, np.float32), np.ones(3, np.float32)])
        with pytest.raises(MetricsTPUUserError, match="ragged"):
            encode_frame("a", 0, [np.ones(2, np.float32), np.ones(3, np.float64)])
        with pytest.raises(MetricsTPUUserError, match="at least one column"):
            encode_frame("a", 0, [])
        # where the JAX package requires one dtype, the port frames mixed dtypes
        # in a version-2 frame (see TestParityWithJax)
        frame, _ = decode_frame(encode_frame("a", 0, [np.ones(2, np.float32), np.ones(2, np.float64)]))
        assert [c.dtype for c in frame.cols] == [np.float32, np.float64]


# ---------------------------------------------------------------------------
# writer: group commit, rotation, recovery, truncation
# ---------------------------------------------------------------------------


class TestWriter:
    def test_append_wait_is_durable_and_ordered(self, tmp_path):
        with WalWriter(str(tmp_path)) as w:
            t0 = w.append_wait("a", [np.ones(3, np.float32)])
            t1 = w.append_wait("a", [np.ones(2, np.float32)])
            assert (t0.seq, t1.seq) == (0, 1) and t0.ok and t1.ok
        assert [f.seq for f in replay_frames(str(tmp_path))] == [0, 1]

    def test_concurrent_appends_share_commits(self, tmp_path):
        before = counter_value("serve.wal_fsyncs")
        with WalWriter(str(tmp_path)) as w:
            tickets = []
            lock = threading.Lock()

            def feed(k):
                for _ in range(25):
                    t = w.append(f"job{k}", [np.ones(4, np.float32)])
                    with lock:
                        tickets.append(t)

            threads = [threading.Thread(target=feed, args=(k,)) for k in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert all(t.wait(10.0) for t in tickets)
            fsyncs = counter_value("serve.wal_fsyncs") - before
            assert 0 < fsyncs <= 100
            seqs = [f.seq for f in replay_frames(str(tmp_path))]
            assert seqs == sorted(seqs) and len(set(seqs)) == 100

    def test_rotation_and_recovery(self, tmp_path):
        w = WalWriter(str(tmp_path), segment_bytes=200)
        for _ in range(6):
            w.append_wait("a", [np.ones(8, np.float32)])
        assert len(w.segments()) > 1
        assert w.lag_rows() == 48
        w.close()
        with pytest.raises(MetricsTPUUserError, match="closed"):
            w.append("a", [np.ones(1, np.float32)])
        w2 = WalWriter(str(tmp_path), segment_bytes=200)
        assert w2.next_seq == 6 and w2.lag_rows() == 48
        t = w2.append_wait("a", [np.ones(8, np.float32)])
        assert t.seq == 6
        w2.close()

    def test_truncate_covered_removes_only_sealed_covered_segments(self, tmp_path):
        w = WalWriter(str(tmp_path), segment_bytes=200)
        for _ in range(9):
            w.append_wait("a", [np.ones(8, np.float32)])
        segments = w.segments()
        assert len(segments) > 2
        before = counter_value("serve.wal_truncated_segments")
        removed = w.truncate_covered({"a": 8})
        assert removed == len(segments) - 1
        assert w.segments() == segments[-1:]
        assert counter_value("serve.wal_truncated_segments") == before + removed
        assert w.truncate_covered({"a": -1}) == 0
        w.close()

    def test_lag_tracks_truncation(self, tmp_path):
        w = WalWriter(str(tmp_path), segment_bytes=200)
        for _ in range(9):
            w.append_wait("a", [np.ones(8, np.float32)])
        lag_before = w.lag_rows()
        w.truncate_covered({"a": 8})
        assert w.lag_rows() < lag_before
        w.close()


# ---------------------------------------------------------------------------
# fault harness: each injected fault pins one recovery policy
# ---------------------------------------------------------------------------


def _build_log(tmp_path, writer_cls=WalWriter):
    """Nine 4-row frames across three 200-byte segments: seqs 0-3 / 4-7 / 8."""
    w = writer_cls(str(tmp_path), segment_bytes=200)
    for i in range(9):
        w.append_wait("a", [np.full(4, float(i), np.float32)])
    w.close()
    return str(tmp_path)


class TestFaults:
    def test_torn_tail_truncates_cleanly_on_reopen(self, tmp_path):
        directory = _build_log(tmp_path)
        last = list_segments(directory)[-1]
        inject_wal_fault(last, "torn_tail")
        before = counter_value("serve.wal_torn_tails")
        w = WalWriter(directory, segment_bytes=200)
        assert counter_value("serve.wal_torn_tails") == before + 1
        assert list(read_segment_frames(last)) == []
        assert w.next_seq == 8
        t = w.append_wait("a", [np.ones(4, np.float32)])
        assert t.seq == 8
        w.close()

    def test_torn_tail_on_last_segment_stops_replay_cleanly(self, tmp_path):
        directory = _build_log(tmp_path)
        inject_wal_fault(list_segments(directory)[-1], "torn_tail")
        frames = list(replay_frames(directory, on_error="raise"))
        assert [f.seq for f in frames] == list(range(8))

    @pytest.mark.parametrize("kind", ["truncate", "bit_flip"])
    def test_mid_stream_damage_raise_policy(self, tmp_path, kind):
        directory = _build_log(tmp_path)
        segments = list_segments(directory)
        assert len(segments) == 3
        inject_wal_fault(segments[1], kind)
        with pytest.raises(WalCorruption):
            list(replay_frames(directory, on_error="raise"))

    @pytest.mark.parametrize("kind", ["truncate", "bit_flip"])
    def test_mid_stream_damage_skip_segment_policy(self, tmp_path, kind):
        directory = _build_log(tmp_path)
        segments = list_segments(directory)
        inject_wal_fault(segments[1], kind)
        seg_before = counter_value("serve.wal_replay_skipped_segments")
        rows_before = counter_value("serve.wal_replay_skipped_rows")
        frames = list(replay_frames(directory, on_error="skip_segment"))
        assert [f.seq for f in frames] == [0, 1, 2, 3, 8]
        assert counter_value("serve.wal_replay_skipped_segments") == seg_before + 1
        lost = counter_value("serve.wal_replay_skipped_rows") - rows_before
        assert lost == (4 if kind == "truncate" else 0)

    def test_unknown_policy_and_kind_rejected(self, tmp_path):
        directory = _build_log(tmp_path)
        with pytest.raises(MetricsTPUUserError, match="on_error"):
            list(replay_frames(directory, on_error="ignore"))
        with pytest.raises(MetricsTPUUserError, match="fault kind"):
            inject_wal_fault(list_segments(directory)[0], "gamma_ray")


# ---------------------------------------------------------------------------
# watermarks: checkpoint extra round-trip + replay dedup
# ---------------------------------------------------------------------------


class TestWatermarks:
    def test_replay_respects_watermarks(self, tmp_path):
        directory = _build_log(tmp_path)
        frames = list(replay_frames(directory, watermarks={"a": 4}))
        assert [f.seq for f in frames] == [5, 6, 7, 8]
        assert list(replay_frames(directory, watermarks={"a": 10**9})) == []

    def test_checkpoint_manager_extra_round_trip(self, tmp_path):
        manager = CheckpointManager(directory=str(tmp_path / "ckpt"))
        metric = MeanSquaredError(**CPU)
        metric.update(np.ones(4, np.float32), np.zeros(4, np.float32))
        manager.save_now(metric, extra={"wal_marks": {"tenants": 17, "mse": 3}})
        fresh = CheckpointManager(directory=str(tmp_path / "ckpt"))
        result = fresh.restore(MeanSquaredError(**CPU))
        assert result.restored_metrics
        assert result.extra == {"wal_marks": {"tenants": 17, "mse": 3}}

    def test_extra_absent_by_default(self, tmp_path):
        manager = CheckpointManager(directory=str(tmp_path / "ckpt"))
        metric = MeanSquaredError(**CPU)
        metric.update(np.ones(2, np.float32), np.zeros(2, np.float32))
        manager.save_now(metric)
        fresh = CheckpointManager(directory=str(tmp_path / "ckpt"))
        result = fresh.restore(MeanSquaredError(**CPU))
        assert result.restored_metrics and result.extra is None


# ---------------------------------------------------------------------------
# exactly-once: worker-side seq dedup (the idempotency key for retries)
# ---------------------------------------------------------------------------


def _server(manager=None, **kw):
    reg = MetricRegistry()
    reg.register("mse", MeanSquaredError(**CPU))
    reg.register("tenants", MultiStreamMetric(MeanSquaredError(**CPU), num_streams=S, **CPU))
    kw.setdefault("block_rows", BLOCK)
    kw.setdefault("flush_interval", 3600.0)
    kw.setdefault("wal_exactly_once", True)
    return EvalServer(reg, config=ServeConfig(**kw), checkpoint_manager=manager)


class TestSeqDedup:
    def test_duplicate_framed_submit_lands_exactly_once(self):
        server = _server().start()
        try:
            rng = np.random.default_rng(1)
            cols = _cols(rng, 12)
            ids = rng.integers(0, S, 12).astype(np.int32)
            assert server.submit_columns("tenants", cols, stream_ids=ids, seqs=[(0, 12)])
            assert server.flush(10.0)
            once = server.registry["tenants"].compute()
            deduped_before = counter_value("serve.wal_deduped_frames")
            assert server.submit_columns("tenants", cols, stream_ids=ids, seqs=[(0, 12)])
            assert server.flush(10.0)
            assert counter_value("serve.wal_deduped_frames") == deduped_before + 1
            assert trees_bitwise_equal(once, server.registry["tenants"].compute())
        finally:
            server.stop(final_checkpoint=False)

    def test_unframed_spans_are_not_deduped(self):
        server = _server().start()
        try:
            cols = [np.full(4, 0.5, np.float32), np.full(4, 1.0, np.float32)]
            for _ in range(2):
                assert server.submit_columns("mse", cols, seqs=[(None, 4)])
            assert server.flush(10.0)
            assert float(server.registry["mse"].compute()) == pytest.approx(0.25)
        finally:
            server.stop(final_checkpoint=False)

    def test_seq_span_rows_must_cover_batch(self):
        server = _server().start()
        try:
            cols = [np.ones(4, np.float32), np.ones(4, np.float32)]
            with pytest.raises(MetricsTPUUserError, match="seqs cover"):
                server.submit_columns("mse", cols, seqs=[(0, 3)])
        finally:
            server.stop(final_checkpoint=False)

    def test_health_and_checkpoint_carry_wal_marks(self, tmp_path):
        server = _server(CheckpointManager(directory=str(tmp_path / "c"))).start()
        try:
            cols = [np.ones(4, np.float32), np.ones(4, np.float32)]
            assert server.submit_columns("mse", cols, seqs=[(5, 4)])
            assert server.flush(10.0)
            assert server.health()["wal_marks"] == {"mse": 5}
            server.checkpoint_now()
            assert server.last_checkpoint_wal_marks == {"mse": 5}
        finally:
            server.stop(final_checkpoint=False)

    def test_restore_seeds_dedup_floor(self, tmp_path):
        server = _server(CheckpointManager(directory=str(tmp_path / "c"))).start()
        cols = [np.full(4, 0.5, np.float32), np.full(4, 1.0, np.float32)]
        assert server.submit_columns("mse", cols, seqs=[(0, 4)])
        assert server.flush(10.0)
        server.checkpoint_now()
        value = server.registry["mse"].compute()
        server.stop(final_checkpoint=False)
        twin = _server(CheckpointManager(directory=str(tmp_path / "c"))).start()
        try:
            assert twin.submit_columns("mse", cols, seqs=[(0, 4)])
            assert twin.flush(10.0)
            assert trees_bitwise_equal(value, twin.registry["mse"].compute())
        finally:
            twin.stop(final_checkpoint=False)


class TestHTTPSeqDedup:
    def test_duplicated_http_forward_lands_exactly_once(self):
        """The same seq-tagged POST delivered twice lands exactly once; the
        client is the JAX package's ``HTTPShard``, so the wire is its own."""
        server = _server(port=0).start()
        try:
            shard = HTTPShard("127.0.0.1", server.port)
            rng = np.random.default_rng(2)
            cols = _cols(rng, 10)
            ids = rng.integers(0, S, 10).astype(np.int32)
            assert shard.ingest_columns("tenants", cols, ids, seqs=[(0, 10)])
            assert shard.flush(10.0)
            once = server.registry["tenants"].compute()
            assert shard.ingest_columns("tenants", cols, ids, seqs=[(0, 10)])
            assert shard.flush(10.0)
            assert trees_bitwise_equal(once, server.registry["tenants"].compute())
        finally:
            server.stop(final_checkpoint=False)

    def test_malformed_seqs_rejected(self):
        server = _server(port=0).start()
        try:
            shard = HTTPShard("127.0.0.1", server.port)
            cols = [np.ones(4, np.float32), np.ones(4, np.float32)]
            assert not shard.ingest_columns("mse", cols, seqs=[(0, 3)])
        finally:
            server.stop(final_checkpoint=False)


# ---------------------------------------------------------------------------
# observability: counters fold into the serve bucket + Prometheus round-trip
# ---------------------------------------------------------------------------


class TestWalObservability:
    def test_wal_counters_summarize_and_round_trip(self, tmp_path):
        with WalWriter(str(tmp_path), segment_bytes=200) as w:
            for _ in range(4):
                w.append_wait("a", [np.ones(8, np.float32)])
            w.truncate_covered({"a": 3})
        serve = summarize_counters().get("serve", {})
        for name in ("wal_appends", "wal_fsyncs", "wal_group_commit_rows", "wal_lag_rows", "wal_truncated_segments"):
            assert name in serve, f"serve.{name} missing from summary"
            assert isinstance(serve[name], int) and serve[name] > 0
        parsed = parse_prometheus_text(prometheus_text())
        wal_rows = {name: value for (name, _labels), value in parsed.items() if name.startswith("metrics_tpu_serve_wal_")}
        assert "metrics_tpu_serve_wal_appends_total" in wal_rows
        assert "metrics_tpu_serve_wal_fsyncs_total" in wal_rows
        assert wal_rows["metrics_tpu_serve_wal_appends_total"] >= 4


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------


FRAME_CASES = {
    "f32_ids": (["tenants"], lambda rng, n: (_cols(rng, n), rng.integers(-3, S, n).astype(np.int32))),
    "f32_plain": (["mse"], lambda rng, n: (_cols(rng, n), None)),
    "f64_one_col": (["q"], lambda rng, n: ([rng.standard_normal(n)], None)),
    "i64_three_cols": (["counts"], lambda rng, n: ([rng.integers(-9, 9, n) for _ in range(3)], None)),
    "bf16_bits_u16": (["raw"], lambda rng, n: ([rng.integers(0, 2**16, n).astype(np.uint16)], None)),
    "unicode_job": (["jöb/ünï:1"], lambda rng, n: (_cols(rng, n), rng.integers(0, S, n).astype(np.int32))),
}


class TestParityWithJax:
    @pytest.mark.parametrize("case", sorted(FRAME_CASES))
    @pytest.mark.parametrize("rows", [1, 7, 64])
    def test_frames_are_byte_equal(self, case, rows):
        (job,), make = FRAME_CASES[case]
        rng = np.random.default_rng(rows)
        cols, ids = make(rng, rows)
        for seq in (0, 123_456_789_012):
            buf = encode_frame(job, seq, cols, ids)
            assert buf == jwal.encode_frame(job, seq, cols, ids)
            jf, jn = jwal.decode_frame(buf)
            tf, tn = decode_frame(buf)
            assert (tf.job, tf.seq, tf.rows, tn) == (jf.job, jf.seq, jf.rows, jn)
            assert [c.tobytes() for c in tf.cols] == [c.tobytes() for c in jf.cols]

    @pytest.mark.parametrize("writer", ["jax", "torch"])
    def test_a_log_replays_in_the_other_package(self, tmp_path, writer):
        writer_cls = jwal.WalWriter if writer == "jax" else WalWriter
        rng = np.random.default_rng(4)
        w = writer_cls(str(tmp_path), segment_bytes=600)
        for i in range(20):
            ids = rng.integers(0, S, 5 + i).astype(np.int32) if i % 2 else None
            w.append_wait("tenants" if i % 2 else "mse", _cols(rng, 5 + i), ids)
        w.close()
        marks = {"mse": 6, "tenants": 11}
        for policy in ("raise", "skip_segment"):
            jframes = list(jwal.replay_frames(str(tmp_path), marks, on_error=policy))
            tframes = list(replay_frames(str(tmp_path), marks, on_error=policy))
            assert len(tframes) == len(jframes) > 0
            for a, b in zip(tframes, jframes):
                assert (a.job, a.seq, a.rows) == (b.job, b.seq, b.rows)
                assert [c.tobytes() for c in a.cols] == [c.tobytes() for c in b.cols]
                assert (a.stream_ids is None) == (b.stream_ids is None)
                assert a.stream_ids is None or a.stream_ids.tobytes() == b.stream_ids.tobytes()
        # either package's writer resumes the other's log at the same seq
        reopened = (WalWriter if writer == "jax" else jwal.WalWriter)(str(tmp_path), segment_bytes=600)
        assert reopened.next_seq == 20 and reopened.lag_rows() == sum(5 + i for i in range(20))
        reopened.close()

    @pytest.mark.parametrize("kind", ["torn_tail", "truncate", "bit_flip"])
    def test_faults_recover_alike(self, tmp_path, kind):
        directory = _build_log(tmp_path / "t", WalWriter)
        twin = _build_log(tmp_path / "j", jwal.WalWriter)
        target = -1 if kind == "torn_tail" else 1
        assert inject_wal_fault(list_segments(directory)[target], kind) == jwal.inject_wal_fault(
            jwal.list_segments(twin)[target], kind
        )
        for a, b in zip(list_segments(directory), jwal.list_segments(twin)):
            assert open(a, "rb").read() == open(b, "rb").read()
        got = [f.seq for f in replay_frames(directory, on_error="skip_segment")]
        want = [f.seq for f in jwal.replay_frames(twin, on_error="skip_segment")]
        assert got == want

    def test_shaped_frames_round_trip_and_the_jax_reader_refuses_them(self, tmp_path):
        rng = np.random.default_rng(6)
        logits = rng.standard_normal((9, 1000)).astype(np.float32)
        labels = rng.integers(0, 1000, 9)
        ids = rng.integers(0, S, 9).astype(np.int32)
        buf = encode_frame("per_class", 3, [logits, labels], ids)
        frame, end = decode_frame(buf)
        assert end == len(buf) and frame.rows == 9
        assert frame.cols[0].shape == (9, 1000) and frame.cols[0].tobytes() == logits.tobytes()
        assert frame.cols[1].dtype == np.int64 and frame.cols[1].tolist() == labels.tolist()
        assert frame.stream_ids.tolist() == ids.tolist()
        with pytest.raises(jwal.WalCorruption, match="unsupported frame version 2"):
            jwal.decode_frame(buf)
        with WalWriter(str(tmp_path)) as w:
            assert w.append_wait("per_class", [logits, labels], ids).rows == 9
        (replayed,) = replay_frames(str(tmp_path))
        assert replayed.cols[0].tobytes() == logits.tobytes()
        with pytest.raises(MetricsTPUUserError, match="ragged"):
            encode_frame("a", 0, [np.ones((2, 3), np.float32), np.float32(1.0)])

    def test_replayed_frames_rebuild_the_state(self, tmp_path):
        """A log the JAX package wrote, replayed into a port server past its
        checkpoint's watermarks, gives the uninterrupted server's state."""
        rng = np.random.default_rng(8)
        batches = [(_cols(rng, 10 + i), rng.integers(-1, S + 1, 10 + i).astype(np.int32)) for i in range(12)]
        w = jwal.WalWriter(str(tmp_path / "wal"))
        seqs = [w.append_wait("tenants", cols, ids).seq for cols, ids in batches]
        w.close()
        full = _server().start()
        drill = _server(CheckpointManager(directory=str(tmp_path / "c"))).start()
        try:
            for seq, (cols, ids) in zip(seqs, batches):
                assert full.submit_columns("tenants", cols, stream_ids=ids, seqs=[(seq, len(ids))])
            for seq, (cols, ids) in list(zip(seqs, batches))[:5]:
                assert drill.submit_columns("tenants", cols, stream_ids=ids, seqs=[(seq, len(ids))])
            drill.checkpoint_now()
            drill.kill()
            restored = _server(CheckpointManager(directory=str(tmp_path / "c"))).start()
            try:
                for frame in replay_frames(str(tmp_path / "wal"), restored.last_checkpoint_wal_marks):
                    assert restored.submit_columns(frame.job, frame.cols, stream_ids=frame.stream_ids,
                                                   seqs=[(frame.seq, frame.rows)])
                assert full.flush(10.0) and restored.flush(10.0)
                assert trees_bitwise_equal(full.registry["tenants"].compute(), restored.registry["tenants"].compute())
                for key in ("stream_rows", "stream_dropped", "sum_squared_error", "total"):
                    got = getattr(restored.registry["tenants"].metric, key)
                    assert trees_bitwise_equal(got, getattr(full.registry["tenants"].metric, key)), key
            finally:
                restored.kill()
        finally:
            full.kill()
