"""The port's serve registry (``metrics_tpu_torch.serve.registry``) on the CPU.

Mirrors ``tests/serve/test_registry.py`` case for case with ``device="cpu"``,
then holds the port against the JAX package: the same updates leave both
registries' ``compute_all()`` and ``export_values()`` equal (inputs are
multiples of 1/8, so float sums are exact in any order and compared
bitwise), and a registry refuses a job on another device than its others.
"""

import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu_torch as T
from metrics_tpu.serve import MetricRegistry as JRegistry
from metrics_tpu_torch import obs
from metrics_tpu_torch.multistream import MultiStreamMetric
from metrics_tpu_torch.regression import MeanSquaredError
from metrics_tpu_torch.serve import MetricRegistry
from metrics_tpu_torch.streaming import StreamingQuantile, TimeDecayedMetric, WindowedMetric
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

CPU = {"device": "cpu"}


def _registry(num_streams=8):
    reg = MetricRegistry()
    reg.register("mse", MeanSquaredError(**CPU))
    reg.register(
        "tenants",
        MultiStreamMetric(MeanSquaredError(**CPU), num_streams=num_streams, **CPU),
        export_top_k=2,
    )
    return reg


class TestRegistration:
    def test_forces_local_read_paths(self):
        metric = MeanSquaredError(sync_on_compute=True, dist_sync_on_step=True, **CPU)
        reg = MetricRegistry()
        reg.register("m", metric)
        assert metric.sync_on_compute is False
        assert metric.dist_sync_on_step is False

    def test_rejects_duplicates_and_bad_names(self):
        reg = _registry()
        with pytest.raises(MetricsTPUUserError, match="already registered"):
            reg.register("mse", MeanSquaredError(**CPU))
        for bad in ("", "-leading", "sp ace", 'quo"te'):
            with pytest.raises(MetricsTPUUserError, match="not a valid label"):
                reg.register(bad, MeanSquaredError(**CPU))
        with pytest.raises(MetricsTPUUserError, match="Metric instance"):
            reg.register("notametric", object())

    def test_kind_detection(self):
        reg = _registry()
        reg.register("w", WindowedMetric(MeanSquaredError(**CPU), window_size=3, **CPU))
        reg.register("d", TimeDecayedMetric(MeanSquaredError(**CPU), half_life=10.0, **CPU))
        kinds = {name: reg[name].kind for name in reg}
        assert kinds == {
            "mse": "plain",
            "tenants": "multistream",
            "w": "windowed",
            "d": "time_decayed",
        }

    def test_dict_protocol(self):
        reg = _registry()
        assert "mse" in reg and "nope" not in reg
        assert len(reg) == 2
        with pytest.raises(KeyError, match="registered"):
            reg["nope"]


class TestQueries:
    def test_multistream_query_paths(self):
        reg = _registry(num_streams=8)
        job = reg["tenants"]
        preds = np.asarray([0.0, 0.0, 1.0, 1.0], np.float32)
        target = np.asarray([0.0, 1.0, 0.0, 1.0], np.float32)
        ids = np.asarray([0, 1, 2, 3], np.int32)
        job.metric.update(preds, target, stream_ids=ids)

        per_stream = np.asarray(job.compute_streams([0, 1, 2, 3]))
        np.testing.assert_allclose(per_stream, [0.0, 1.0, 1.0, 0.0])

        values, top_ids = job.top_k(2)
        assert sorted(int(i) for i in np.asarray(top_ids)) == [1, 2]
        np.testing.assert_allclose(np.asarray(values), [1.0, 1.0])

        hit_ids, total = job.where_op("ge", 1.0, k=4)
        matched = [int(i) for i in np.asarray(hit_ids) if int(i) >= 0]
        assert sorted(matched) == [1, 2]
        assert int(np.asarray(total)) == 2

    def test_query_guards(self):
        reg = _registry()
        with pytest.raises(MetricsTPUUserError, match="MultiStreamMetric job"):
            reg["mse"].compute_streams([0])
        with pytest.raises(MetricsTPUUserError, match="MultiStreamMetric job"):
            reg["mse"].top_k(2)
        with pytest.raises(MetricsTPUUserError, match="unknown where-op"):
            reg["tenants"].where_op("contains", 0.5, k=2)
        with pytest.raises(MetricsTPUUserError, match="only windowed jobs"):
            reg["mse"].advance_window()


class TestExports:
    def test_scalar_and_component_exports(self):
        reg = MetricRegistry()
        reg.register("mse", MeanSquaredError(**CPU))
        reg.register("q", StreamingQuantile(q=(0.5, 0.99), **CPU), components=("p50", "p99"))
        reg["mse"].metric.update(np.asarray([1.0, 0.0], np.float32), np.asarray([0.0, 0.0], np.float32))
        reg["q"].metric.update(np.arange(100, dtype=np.float32))
        values = reg.export_values()
        assert values["mse"] == pytest.approx(0.5)
        assert set(values["q"]) == {"p50", "p99"}

    def test_component_name_arity_checked(self):
        reg = MetricRegistry()
        reg.register("q", StreamingQuantile(q=(0.5, 0.9, 0.99), **CPU), components=("a", "b"))
        reg["q"].metric.update(np.arange(10, dtype=np.float32))
        with pytest.raises(MetricsTPUUserError, match="component name"):
            reg["q"].export_values()

    def test_multistream_export_is_bounded(self):
        reg = _registry(num_streams=8)
        job = reg["tenants"]
        job.metric.update(
            np.asarray([1.0, 0.0], np.float32),
            np.asarray([0.0, 0.0], np.float32),
            stream_ids=np.asarray([3, 5], np.int32),
        )
        out = job.export_values()
        labels = [dict(lbl) for lbl, _v in out]
        assert {"component": "active_streams"} in labels
        assert {"component": "dropped_rows"} in labels
        streams = [lbl["stream"] for lbl in labels if "stream" in lbl]
        assert len(streams) == 2  # export_top_k, never all 8 streams
        rendered = obs.metric_values_prometheus_text(reg)
        parsed = obs.parse_prometheus_text(rendered)
        assert (
            "metrics_tpu_metric_value",
            (("job", "tenants"), ("component", "active_streams")),
        ) in parsed


class TestDurability:
    def test_checkpoint_target_keeps_jobs_independent(self):
        reg = MetricRegistry()
        reg.register("a", MeanSquaredError(**CPU))
        reg.register("b", MeanSquaredError(**CPU))
        target = reg.checkpoint_target()
        reg["a"].metric.update(np.asarray([1.0], np.float32), np.asarray([0.0], np.float32))
        # compute_groups=False: identical-schema tenants must never alias
        assert float(reg["a"].metric.sum_squared_error) == 1.0
        assert float(reg["b"].metric.sum_squared_error) == 0.0
        assert target is reg.checkpoint_target()  # cached
        reg.register("c", T.MeanMetric(**CPU))
        assert target is not reg.checkpoint_target()  # invalidated on register

    def test_checkpoint_target_empty_registry_raises(self):
        with pytest.raises(MetricsTPUUserError, match="empty registry"):
            MetricRegistry().checkpoint_target()

    def test_locked_takes_and_releases_every_job(self):
        reg = _registry()
        with reg.locked():
            for job in reg.jobs():
                # RLock: re-acquire from the owning thread succeeds
                assert job.lock.acquire(blocking=False)
                job.lock.release()
        for job in reg.jobs():
            assert job.lock.acquire(blocking=False)
            job.lock.release()


# ---------------------------------------------------------------------------
# the port's own rules: one device per registry, values read with one .cpu()
# ---------------------------------------------------------------------------


class TestDevices:
    def test_a_job_on_another_device_is_refused_at_register(self):
        reg = _registry()
        assert reg.device == torch.device("cpu")
        other = MeanSquaredError(**CPU)
        other.device = torch.device("cuda", 0)  # as a metric built with device="cuda" reports it
        with pytest.raises(MetricsTPUUserError, match="one registry serves one device"):
            reg.register("elsewhere", other)
        assert "elsewhere" not in reg
        with pytest.raises(MetricsTPUUserError, match="keeps its state on"):
            reg.rebind("mse", other)
        assert reg.checkpoint_target().device == torch.device("cpu")

    def test_empty_registry_has_no_device(self):
        assert MetricRegistry().device is None

    def test_a_default_device_metric_fails_at_construction_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MetricRegistry().register("mse", MeanSquaredError())

    def test_reads_return_host_floats(self):
        reg = _registry()
        reg["tenants"].metric.update(
            np.asarray([0.5, 0.25], np.float32), np.asarray([0.0, 0.0], np.float32),
            stream_ids=np.asarray([1, 6], np.int32),
        )
        out = reg.compute_all()
        assert isinstance(out["mse"], float) and np.isnan(out["mse"])
        assert out["tenants"][1] == 0.25 and out["tenants"][6] == 0.0625
        assert all(isinstance(v, float) for v in out["tenants"])


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def _pair_registries():
    regs = {}
    for pkg, reg_cls, kw in ((J, JRegistry, {}), (T, MetricRegistry, CPU)):
        reg = reg_cls()
        reg.register("mse", pkg.MeanSquaredError(**kw))
        reg.register("tenants", pkg.MultiStreamMetric(pkg.MeanSquaredError(**kw), num_streams=8, **kw), export_top_k=3)
        reg.register("q", pkg.StreamingQuantile(q=(0.5, 0.9), capacity=16, **kw), components=("p50", "p90"))
        reg.register("acc", pkg.Accuracy(num_classes=4, **kw))
        regs[pkg] = reg
    return regs


def _feed_pair(regs, seed):
    rng = np.random.default_rng(seed)
    for _ in range(3):
        p = (rng.integers(0, 64, 40) / 8).astype(np.float32)
        t = (rng.integers(0, 64, 40) / 8).astype(np.float32)
        ids = rng.integers(-1, 10, 40).astype(np.int32)  # out-of-range ids on both sides
        logits = (rng.integers(-16, 16, (40, 4)) / 8).astype(np.float32)
        labels = rng.integers(0, 4, 40)
        for pkg, reg in regs.items():
            reg["mse"].metric.update(p, t)
            reg["tenants"].metric.update(p, t, stream_ids=ids)
            reg["q"].metric.update(p)
            reg["acc"].metric.update(logits, labels)


class TestParityWithJax:
    def test_compute_all_and_exports_equal_the_jax_registry(self):
        regs = _pair_registries()
        _feed_pair(regs, 3)
        jout, tout = regs[J].compute_all(), regs[T].compute_all()
        assert jout.keys() == tout.keys()
        for name in jout:
            assert np.asarray(tout[name], np.float64).tobytes() == np.asarray(jout[name], np.float64).tobytes(), name
        assert regs[T].export_values() == regs[J].export_values()
        assert regs[T].describe() == regs[J].describe()
        assert obs.metric_values_prometheus_text(regs[T]) == J.obs.metric_values_prometheus_text(regs[J])

    def test_stream_reads_equal_the_jax_registry(self):
        regs = _pair_registries()
        _feed_pair(regs, 4)
        jjob, tjob = regs[J]["tenants"], regs[T]["tenants"]
        from metrics_tpu.serve.registry import _to_jsonable as jjson
        from metrics_tpu_torch.serve.registry import _to_jsonable as tjson

        assert tjson(tjob.compute_streams([0, 3, 7])) == jjson(jjob.compute_streams([0, 3, 7]))
        (tv, ti), (jv, ji) = tjob.top_k(4), jjob.top_k(4)
        assert tjson(tv) == jjson(jv) and np.asarray(ti).tolist() == np.asarray(ji).tolist()
        for op in ("gt", "ge", "lt", "le"):
            (tids, ttotal), (jids, jtotal) = tjob.where_op(op, 9.0, k=5), jjob.where_op(op, 9.0, k=5)
            assert np.asarray(tids).tolist() == np.asarray(jids).tolist()
            assert int(ttotal) == int(np.asarray(jtotal))
