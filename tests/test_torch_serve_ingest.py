"""The port's ingestion pipeline and traffic (``metrics_tpu_torch.serve.{ingest,traffic}``) on the CPU.

Mirrors ``tests/serve/test_ingest.py`` case for case with ``device="cpu"``
(the traffic determinism case included), then holds the port against the
JAX package: the same seeded traffic through both packages' batchers
dispatches the same pieces (``_pow2_chunks`` for plain jobs, padded blocks
with ``num_valid`` for multistream jobs) and leaves integer states bitwise
equal, and float states bitwise equal on multiples of 1/8; ``default_traffic``
gives the same records; each flush hands the metric tensors on its device.
"""

import math
import threading

import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu_torch as T
from metrics_tpu.serve import BlockBatcher as JBatcher
from metrics_tpu.serve import MetricRegistry as JRegistry
from metrics_tpu.serve import Record as JRecord
from metrics_tpu.serve import default_traffic as jdefault_traffic
from metrics_tpu_torch.multistream import MultiStreamMetric
from metrics_tpu_torch.obs import counter_value
from metrics_tpu_torch.regression import MeanSquaredError
from metrics_tpu_torch.serve import (
    BlockBatcher,
    IngestConsumer,
    IngestQueue,
    JobTraffic,
    MetricRegistry,
    Record,
    TrafficGenerator,
    default_traffic,
)
from metrics_tpu_torch.serve.ingest import _FlushToken, _pow2_chunks
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

CPU = {"device": "cpu"}


def _plain_registry():
    reg = MetricRegistry()
    reg.register("mse", MeanSquaredError(**CPU))
    return reg


def _multi_registry(num_streams=8):
    reg = MetricRegistry()
    reg.register("tenants", MultiStreamMetric(MeanSquaredError(**CPU), num_streams=num_streams, **CPU))
    return reg


class TestPow2Chunks:
    @pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 8, 9, 31, 32, 33, 100, 255, 257])
    def test_covers_exactly_with_bounded_shape_set(self, n):
        cap = 32
        chunks = _pow2_chunks(n, cap)
        assert sum(chunks) == n
        assert all(c & (c - 1) == 0 and 0 < c <= cap for c in chunks)
        assert len(set(chunks)) <= int(math.log2(cap)) + 1


class TestBlockBatcher:
    def test_plain_batching_matches_direct_update(self):
        reg = _plain_registry()
        batcher = BlockBatcher(reg["mse"], block_rows=8)
        rng = np.random.default_rng(0)
        preds = rng.uniform(size=21).astype(np.float32)
        target = rng.uniform(size=21).astype(np.float32)
        for p, t in zip(preds, target):
            batcher.add(Record("mse", (p, t)))
        batcher.flush()

        direct = MeanSquaredError(**CPU)
        direct.update(preds, target)
        np.testing.assert_allclose(np.asarray(reg["mse"].compute()), np.asarray(direct.compute()), rtol=1e-6)
        # 21 rows at cap 8 -> chunks 8+8+4+1 = four fixed-shape dispatches
        assert reg["mse"].blocks_dispatched == 4
        assert reg["mse"].records_ingested == 21

    def test_multistream_padding_is_bit_exact(self):
        """A short padded block computes bit-identically to the unpadded rows:
        pad rows carry stream_id -1 and are dropped by the scatter."""
        S = 8
        reg = _multi_registry(S)
        batcher = BlockBatcher(reg["tenants"], block_rows=16)
        rng = np.random.default_rng(1)
        preds = rng.uniform(size=10).astype(np.float32)
        target = rng.uniform(size=10).astype(np.float32)
        ids = rng.integers(0, S, size=10).astype(np.int32)
        for p, t, s in zip(preds, target, ids):
            batcher.add(Record("tenants", (p, t), int(s)))
        batcher.flush()
        assert batcher.rows_padded == 6

        direct = MultiStreamMetric(MeanSquaredError(**CPU), num_streams=S, **CPU)
        direct.update(preds, target, stream_ids=ids)
        got = np.asarray(reg["tenants"].compute())
        want = np.asarray(direct.compute())
        assert got.shape == want.shape
        assert np.all(got.view(np.uint32) == want.view(np.uint32))
        # num_valid keeps the 6 pad rows out of the drop signal...
        assert reg["tenants"].metric.dropped_rows() == 0
        # ...while a genuinely out-of-range client row still counts
        batcher.add(Record("tenants", (np.float32(0.5), np.float32(0.5)), S))
        batcher.flush()
        assert reg["tenants"].metric.dropped_rows() == 1

    def test_capacity_autoflush(self):
        reg = _plain_registry()
        batcher = BlockBatcher(reg["mse"], block_rows=4)
        for i in range(4):
            batcher.add(Record("mse", (np.float32(i), np.float32(0))))
        assert len(batcher) == 0
        assert reg["mse"].records_ingested == 4

    def test_nonforced_flush_carries_the_residue(self):
        reg = _plain_registry()
        batcher = BlockBatcher(reg["mse"], block_rows=8)
        for i in range(21):
            batcher.add(Record("mse", (np.float32(i), np.float32(0))))
        assert reg["mse"].blocks_dispatched == 2
        assert reg["mse"].records_ingested == 16
        assert len(batcher) == 5
        assert batcher.flush(force=False) == 0
        assert reg["mse"].blocks_dispatched == 2
        assert len(batcher) == 5
        for i in range(3):
            batcher.add(Record("mse", (np.float32(i), np.float32(1))))
        assert reg["mse"].blocks_dispatched == 3
        assert len(batcher) == 0
        for i in range(5):
            batcher.add(Record("mse", (np.float32(i), np.float32(2))))
        assert batcher.flush(force=True) == 5
        assert reg["mse"].blocks_dispatched == 5
        assert reg["mse"].records_ingested == 29

    def test_carry_keeps_the_oldest_row_age(self):
        reg = _plain_registry()
        batcher = BlockBatcher(reg["mse"], block_rows=8)
        assert batcher.age(now=123.0) == 0.0
        batcher.add(Record("mse", (1.0, 0.0)))
        assert batcher.age() > 0.0
        batcher.flush(force=False)
        assert len(batcher) == 1 and batcher.age() > 0.0
        batcher.flush(force=True)
        assert batcher.age(now=123.0) == 0.0

    def test_multistream_carry_defers_padding(self):
        S = 8
        reg = _multi_registry(S)
        batcher = BlockBatcher(reg["tenants"], block_rows=8)
        rng = np.random.default_rng(7)
        preds = rng.uniform(size=21).astype(np.float32)
        target = rng.uniform(size=21).astype(np.float32)
        ids = rng.integers(0, S, size=21).astype(np.int32)
        batcher.extend_columns([preds, target], ids)
        assert reg["tenants"].blocks_dispatched == 2
        assert batcher.rows_padded == 0
        assert len(batcher) == 5
        assert batcher.flush(force=True) == 5
        assert reg["tenants"].blocks_dispatched == 3
        assert batcher.rows_padded == 3

        direct = MultiStreamMetric(MeanSquaredError(**CPU), num_streams=S, **CPU)
        direct.update(preds, target, stream_ids=ids)
        np.testing.assert_array_equal(np.asarray(reg["tenants"].compute()), np.asarray(direct.compute()))

    def test_extend_columns_matches_per_record_adds(self):
        reg_cols, reg_rows = _multi_registry(), _multi_registry()
        cols_batcher = BlockBatcher(reg_cols["tenants"], block_rows=8)
        rows_batcher = BlockBatcher(reg_rows["tenants"], block_rows=8)
        rng = np.random.default_rng(8)
        preds = rng.uniform(size=13).astype(np.float32)
        target = rng.uniform(size=13).astype(np.float32)
        ids = rng.integers(0, 8, size=13).astype(np.int32)
        cols_batcher.extend_columns([preds, target], ids)
        for p, t, s in zip(preds, target, ids):
            rows_batcher.add(Record("tenants", (p, t), int(s)))
        cols_batcher.flush()
        rows_batcher.flush()
        np.testing.assert_array_equal(np.asarray(reg_cols["tenants"].compute()), np.asarray(reg_rows["tenants"].compute()))
        assert reg_cols["tenants"].blocks_dispatched == reg_rows["tenants"].blocks_dispatched

    def test_validation(self):
        reg = _plain_registry()
        mreg = _multi_registry()
        with pytest.raises(MetricsTPUUserError, match="power of two"):
            BlockBatcher(reg["mse"], block_rows=12)
        with pytest.raises(MetricsTPUUserError, match="stream_id"):
            BlockBatcher(mreg["tenants"]).add(Record("tenants", (1.0, 2.0)))
        with pytest.raises(MetricsTPUUserError, match="stream_id must be None"):
            BlockBatcher(reg["mse"]).add(Record("mse", (1.0, 2.0), stream_id=3))
        with pytest.raises(MetricsTPUUserError, match="mixed arity"):
            b = BlockBatcher(reg["mse"])
            b.add(Record("mse", (1.0, 2.0)))
            b.add(Record("mse", (1.0,)))
            b.flush()


class TestIngestQueue:
    def test_bounded_rejection_is_counted(self):
        q = IngestQueue(capacity=3)
        rec = Record("mse", (1.0, 2.0))
        before = counter_value("serve.records_rejected")
        assert all(q.put(rec) for _ in range(3))
        assert q.put(rec) is False
        assert q.depth() == 3
        assert counter_value("serve.records_rejected") == before + 1

    def test_get_timeout_returns_none(self):
        assert IngestQueue(capacity=2).get(timeout=0.01) is None

    def test_put_control_timeout_returns_false_when_full(self):
        q = IngestQueue(capacity=1)
        assert q.put(Record("mse", (1.0, 2.0)))
        assert q.put_control(_FlushToken(), timeout=0.05) is False


class TestIngestConsumer:
    def _run_consumer(self, registry, consumer_kwargs=None):
        q = IngestQueue(capacity=1024)
        consumer = IngestConsumer(registry, q, **(consumer_kwargs or {}))
        thread = threading.Thread(target=consumer.run, daemon=True)
        thread.start()
        return q, consumer, thread

    def test_routes_flushes_and_drains(self):
        reg = _plain_registry()
        q, consumer, thread = self._run_consumer(reg, {"block_rows": 8, "flush_interval": 3600.0})
        rng = np.random.default_rng(2)
        preds = rng.uniform(size=5).astype(np.float32)
        target = rng.uniform(size=5).astype(np.float32)
        for p, t in zip(preds, target):
            assert q.put(Record("mse", (p, t)))
        token = _FlushToken()
        q.put_control(token)
        assert token.done.wait(10.0)
        direct = MeanSquaredError(**CPU)
        direct.update(preds, target)
        np.testing.assert_allclose(np.asarray(reg["mse"].compute()), np.asarray(direct.compute()), rtol=1e-6)
        consumer.stop.set()
        thread.join(timeout=10.0)
        assert not thread.is_alive()

    def test_unroutable_and_malformed_are_counted_not_fatal(self):
        reg = _plain_registry()
        before_unroutable = counter_value("serve.records_unroutable")
        before_malformed = counter_value("serve.records_malformed")
        q, consumer, thread = self._run_consumer(reg)
        q.put(Record("nope", (1.0, 2.0)))
        q.put(Record("mse", (1.0, 2.0), stream_id=5))
        q.put(Record("mse", (np.float32(1.0), np.float32(2.0))))
        token = _FlushToken()
        q.put_control(token)
        assert token.done.wait(10.0)
        consumer.stop.set()
        thread.join(timeout=10.0)
        assert counter_value("serve.records_unroutable") == before_unroutable + 1
        assert counter_value("serve.records_malformed") == before_malformed + 1
        assert reg["mse"].records_ingested == 1
        assert len(consumer.errors) == 2

    def test_untrusted_rows_cannot_kill_the_writer(self):
        reg = _plain_registry()
        reg.register("tenants", MultiStreamMetric(MeanSquaredError(**CPU), num_streams=4, **CPU))
        before_malformed = counter_value("serve.records_malformed")
        before_flush_fail = counter_value("serve.flush_failures", job="mse")
        q, consumer, thread = self._run_consumer(reg, {"block_rows": 8, "flush_interval": 3600.0})
        q.put(Record("tenants", (1.0, 2.0), "oops"))
        q.put(Record("mse", (np.zeros(2, np.float32), np.zeros(2, np.float32))))
        q.put(Record("mse", (np.zeros(3, np.float32), np.zeros(3, np.float32))))
        token = _FlushToken()
        q.put_control(token)
        assert token.done.wait(10.0)
        assert thread.is_alive()
        q.put(Record("mse", (np.float32(1.0), np.float32(0.0))))
        token = _FlushToken()
        q.put_control(token)
        assert token.done.wait(10.0)
        consumer.stop.set()
        thread.join(timeout=10.0)
        assert counter_value("serve.records_malformed") == before_malformed + 1
        assert counter_value("serve.flush_failures", job="mse") == before_flush_fail + 1
        assert reg["mse"].records_ingested == 1
        assert consumer.errors_total == 2

    def test_late_registered_job_is_routed(self):
        reg = _plain_registry()
        q, consumer, thread = self._run_consumer(reg, {"flush_interval": 3600.0})
        late = reg.register("late_mse", MeanSquaredError(**CPU))
        q.put(Record("late_mse", (np.float32(1.0), np.float32(0.0))))
        token = _FlushToken()
        q.put_control(token)
        assert token.done.wait(10.0)
        consumer.stop.set()
        thread.join(timeout=10.0)
        assert late.records_ingested == 1
        assert "late_mse" in consumer.batchers

    def test_kill_drops_the_queue(self):
        reg = _plain_registry()
        q, consumer, thread = self._run_consumer(reg, {"block_rows": 64, "flush_interval": 3600.0})
        for _ in range(10):
            q.put(Record("mse", (np.float32(0.5), np.float32(0.25))))
        token = _FlushToken()
        q.put_control(token)
        assert token.done.wait(10.0)
        ingested_at_kill = reg["mse"].records_ingested
        for _ in range(7):
            q.put(Record("mse", (np.float32(0.5), np.float32(0.25))))
        consumer.kill.set()
        thread.join(timeout=10.0)
        assert reg["mse"].records_ingested == ingested_at_kill


class TestTrafficDeterminism:
    def test_record_is_pure_in_seed_and_index(self):
        specs = [
            JobTraffic("a", arity=2),
            JobTraffic("b", arity=1, num_streams=4, oob_every=5),
        ]
        t1 = TrafficGenerator(specs, seed=3)
        t2 = TrafficGenerator(specs, seed=3)
        replayed = list(t2.replay(0, 40))
        for i in reversed(range(40)):
            a, b = t1.record(i), replayed[i]
            assert a.job == b.job and a.stream_id == b.stream_id
            assert all(float(x) == float(y) for x, y in zip(a.values, b.values))
        assert any(r.stream_id is not None and r.stream_id >= 4 for r in replayed)


# ---------------------------------------------------------------------------
# the port's own rules: uploads to the job's device, pieces as the JAX package's
# ---------------------------------------------------------------------------


def _spy(metric, calls):
    real = metric.update

    def update(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    metric.update = update


class TestUpload:
    def test_flush_hands_the_metric_tensors_on_its_device(self):
        reg = _multi_registry()
        reg.register("mse", MeanSquaredError(**CPU))
        calls = {"tenants": [], "mse": []}
        for name in calls:
            _spy(reg[name].metric, calls[name])
        rng = np.random.default_rng(5)
        cols = [rng.uniform(size=12).astype(np.float32) for _ in range(2)]
        ro = [np.frombuffer(c.tobytes(), np.float32) for c in cols]  # read-only, as a request body's views
        ids = np.frombuffer(rng.integers(0, 8, 12).astype(np.int32).tobytes(), np.int32)
        BlockBatcher(reg["tenants"], block_rows=8).extend_columns(ro, ids)
        b = BlockBatcher(reg["mse"], block_rows=8)
        b.extend_columns(ro)
        b.flush()
        (args, kwargs), = calls["tenants"]
        assert all(isinstance(a, torch.Tensor) and a.device.type == "cpu" for a in args)
        assert kwargs["stream_ids"].dtype == torch.int32 and kwargs["num_valid"].tolist() == [8]
        assert [a[0].shape[0] for a, _ in calls["mse"]] == [8, 4]
        assert all(isinstance(x, torch.Tensor) for a, _ in calls["mse"] for x in a)

    def test_pad_rows_are_zeros_with_id_minus_one(self):
        reg = _multi_registry()
        calls = []
        _spy(reg["tenants"].metric, calls)
        b = BlockBatcher(reg["tenants"], block_rows=8)
        b.extend_columns([np.full(3, 0.5, np.float32), np.full(3, 0.25, np.float32)], np.asarray([1, 2, 9], np.int32))
        b.flush()
        (args, kwargs), = calls
        assert args[0].tolist() == [0.5] * 3 + [0.0] * 5
        assert kwargs["stream_ids"].tolist() == [1, 2, 9] + [-1] * 5
        assert kwargs["num_valid"].tolist() == [3]
        assert reg["tenants"].metric.dropped_rows() == 1


def _pair(seed=0, S=8):
    out = {}
    for pkg, reg_cls, kw in ((J, JRegistry, {}), (T, MetricRegistry, CPU)):
        reg = reg_cls()
        reg.register("mse", pkg.MeanSquaredError(**kw))
        reg.register("tenants", pkg.MultiStreamMetric(pkg.MeanSquaredError(**kw), num_streams=S, **kw))
        reg.register("acc", pkg.MultiStreamMetric(pkg.Accuracy(num_classes=5, **kw), num_streams=S, **kw))
        reg.register("q", pkg.StreamingQuantile(q=(0.5, 0.99), capacity=16, **kw))
        out[pkg] = reg
    return out


def _same_tree(got, want, where):
    """Every leaf bitwise equal (a sketch state is a dict of leaves)."""
    assert got.keys() == want.keys(), where
    for key in want:
        if isinstance(want[key], dict):
            _same_tree(got[key], want[key], (where, key))
        else:
            assert np.asarray(got[key]).tobytes() == np.asarray(want[key]).tobytes(), (where, key)


class TestParityWithJax:
    def test_default_traffic_gives_the_jax_records(self):
        regs = _pair()
        jt, tt = jdefault_traffic(regs[J], seed=5), default_traffic(regs[T], seed=5)
        for i in range(200):
            a, b = jt.record(i), tt.record(i)
            assert (a.job, a.stream_id) == (b.job, b.stream_id)
            assert [np.asarray(x).tobytes() for x in a.values] == [np.asarray(x).tobytes() for x in b.values]

    @pytest.mark.parametrize("block_rows", [8, 32])
    def test_same_traffic_same_pieces_same_states(self, block_rows):
        regs = _pair()
        rng = np.random.default_rng(block_rows)
        pieces = {J: {}, T: {}}
        batchers = {}
        for pkg, reg in regs.items():
            batcher_cls, record_cls = (JBatcher, JRecord) if pkg is J else (BlockBatcher, Record)
            batchers[pkg] = ({name: batcher_cls(reg[name], block_rows=block_rows) for name in reg}, record_cls)
            for name in reg:
                calls = pieces[pkg].setdefault(name, [])
                _spy(reg[name].metric, calls)
        for step in range(6):
            n = int(rng.integers(1, 3 * block_rows))
            p = (rng.integers(0, 64, n) / 8).astype(np.float32)
            t = (rng.integers(0, 64, n) / 8).astype(np.float32)
            ids = rng.integers(-2, 11, n).astype(np.int32)
            logits = (rng.integers(-16, 16, (n, 5)) / 8).astype(np.float32)
            labels = rng.integers(0, 5, n)
            force = step % 2 == 1
            for pkg, (bs, record_cls) in batchers.items():
                if step % 3 == 2:  # row records through add()
                    for i in range(n):
                        bs["mse"].add(record_cls("mse", (p[i], t[i])))
                        bs["tenants"].add(record_cls("tenants", (p[i], t[i]), int(ids[i])))
                else:
                    bs["mse"].extend_columns([p, t])
                    bs["tenants"].extend_columns([p, t], ids)
                bs["acc"].extend_columns([logits, labels], ids)
                bs["q"].extend_columns([p])
                for b in bs.values():
                    b.flush(force=force)
        for pkg, (bs, _) in batchers.items():
            for b in bs.values():
                b.flush()
        for name in regs[T]:
            shape_of = lambda calls: [  # noqa: E731
                (tuple(np.shape(a[0])), None if "num_valid" not in kw else int(np.asarray(kw["num_valid"])[0]))
                for a, kw in calls
            ]
            assert shape_of(pieces[T][name]) == shape_of(pieces[J][name]), name
            _same_tree(regs[T][name].metric.state_pytree(), regs[J][name].metric.state_pytree(), name)
            assert regs[T][name].blocks_dispatched == regs[J][name].blocks_dispatched
            assert regs[T][name].records_ingested == regs[J][name].records_ingested
        assert batchers[T][0]["tenants"].rows_padded == batchers[J][0]["tenants"].rows_padded
