"""The port's observability layer (``metrics_tpu_torch.obs``) against the JAX package's.

The cases of ``tests/bases/test_obs.py`` that do not need a compiler run
against the port: the disabled no-op, spans and their nesting under a
collection, exporters, ``warn_once`` and the sync-report ring.  Then parity:

* the same sequence (an ``Accuracy`` update and compute, a collection
  compute, a ``CatMetric`` synced twice over a ``LoopbackBackend``, a chaos
  fault) gives the same counter names, labels and values in both packages,
  apart from the buckets the port has no counterpart for (:data:`NO_COUNTERPART`);
* ``prometheus_text()``, ``summarize_counters()`` and
  ``metric_values_prometheus_text()`` are byte-equal for identical counters
  and spans.

Each package keeps its own registry; both are reset around every test.
"""

import json
import warnings

import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.parallel as jp
import metrics_tpu_torch as mt
import metrics_tpu_torch.parallel as tp
from metrics_tpu import obs as jobs
from metrics_tpu_torch import obs
from metrics_tpu_torch.obs import core as obs_core
from metrics_tpu_torch.obs.logging import warn_once

# counters the JAX package keeps for machinery the port does not have: jit
# traces and eager demotions (the port compiles nothing) and the key-value
# fallback of its multihost gathers
NO_COUNTERPART = ("jit_traces", "eager_fallback", "sync.kv_fallback_gathers")
EAGER = {"jit_update": False, "jit_compute": False}
C = 5


@pytest.fixture(autouse=True)
def _fresh_obs():
    for registry in (obs, jobs):
        registry.reset()
        registry.disable()
    yield
    for registry in (obs, jobs):
        registry.reset()
        registry.disable()


class DummyMetricSum(mt.Metric):
    full_state_update = True

    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("x", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, x):
        self.x = self.x + torch.as_tensor(x, dtype=torch.float32)

    def compute(self):
        return self.x


def _span_names():
    return sorted({name for (name, _labels) in obs_core.spans_snapshot()})


def _chaos_metric(**kwargs):
    return DummyMetricSum(
        sync_backend=tp.ChaosBackend(tp.NullBackend(), world_size=2, options=tp.SyncOptions(timeout=None)),
        **kwargs,
    )


def _batch(seed: int = 0, n: int = 12):
    rng = np.random.default_rng(seed)
    return rng.integers(0, C, n), rng.integers(0, C, n)


# ------------------------------------------------------------- disabled mode
class TestDisabledNoOp:
    def test_span_returns_shared_noop_singleton(self):
        assert obs.span("anything", metric="X") is obs_core.NOOP_SPAN
        with obs.span("anything") as s:
            s.set(extra=1)
        assert obs_core.spans_snapshot() == {}

    def test_metric_use_records_no_spans(self):
        m = mt.Accuracy(num_classes=3, device="cpu")
        m.update(torch.tensor([0, 1, 2]), torch.tensor([0, 1, 1]))
        m.compute()
        assert obs_core.spans_snapshot() == {}

    def test_counters_still_tick_while_disabled(self):
        m = _chaos_metric()
        m.update(1.0)
        m.compute()
        assert obs.counter_value("sync.reports", metric="DummyMetricSum") == 1

    def test_enabled_flag_roundtrip(self):
        assert not obs.enabled()
        obs.enable()
        assert obs.enabled()
        assert not isinstance(obs.span("x"), obs_core._NoopSpan)
        obs.disable()
        assert obs.span("x") is obs_core.NOOP_SPAN


# ----------------------------------------------------------- spans + nesting
class TestSpans:
    def test_metric_update_forward_compute_sync_spanned(self):
        obs.enable()
        m = _chaos_metric()
        m.update(1.0)
        m(2.0)
        m.compute()
        assert {"metric.update", "metric.forward", "metric.compute", "metric.sync"} <= set(_span_names())

    def test_forward_updates_are_not_spanned_as_updates(self):
        # as in the JAX package, forward's own update runs under metric.forward
        obs.enable()
        m = mt.SumMetric(device="cpu")
        m(torch.tensor(1.0))
        updates = [k for k in obs_core.spans_snapshot() if k[0] == "metric.update"]
        assert updates == []

    def test_collection_compute_attributes_members_as_parents(self):
        obs.enable()
        mc = mt.MetricCollection(
            {"acc": mt.Accuracy(num_classes=3, device="cpu"), "mse": mt.MeanSquaredError(device="cpu")},
            compute_groups=False,
            device="cpu",
        )
        mc.update(torch.tensor([0, 1, 2]), torch.tensor([0, 1, 1]))
        mc.compute()
        spans = obs_core.spans_snapshot()
        member_updates = [dict(labels) for (name, labels) in spans if name == "metric.update"]
        assert {d.get("metric") for d in member_updates} >= {"Accuracy", "MeanSquaredError"}
        assert all(d.get("parent") == "collection.update" for d in member_updates)
        member_computes = [dict(labels) for (name, labels) in spans if name == "metric.compute"]
        assert member_computes and all(d.get("parent") == "collection.compute" for d in member_computes)

    def test_collection_forward_and_update_batched_spanned(self):
        obs.enable()
        mc = mt.MetricCollection({"acc": mt.Accuracy(num_classes=3, device="cpu")}, compute_groups=False, device="cpu")
        mc(torch.tensor([0, 1, 2]), torch.tensor([0, 1, 1]))
        mc.update_batched(torch.tensor([[0, 1, 2]]), torch.tensor([[0, 1, 1]]))
        assert {"collection.forward", "collection.update_batched"} <= set(_span_names())

    def test_span_aggregates_count_total_max(self):
        obs.enable()
        for _ in range(3):
            with obs.span("unit.test", case="agg"):
                pass
        ((_, agg),) = [item for item in obs_core.spans_snapshot().items() if item[0][0] == "unit.test"]
        assert agg[0] == 3
        assert agg[1] >= agg[2] >= 0


# ------------------------------------------------------------------ exporters
class TestExporters:
    def test_report_contains_all_sections(self):
        obs.enable()
        m = _chaos_metric()
        m.update(1.0)
        m.compute()
        rep = obs.report()
        assert rep["enabled"] is True
        assert "sync.reports" in {c["name"] for c in rep["counters"]}
        assert {s["name"] for s in rep["spans"]} >= {"metric.update", "metric.compute", "metric.sync"}
        assert rep["sync_reports"] and rep["sync_reports"][-1]["metric"] == "DummyMetricSum"
        assert rep["recent_events"]

    def test_prometheus_round_trip(self):
        obs.enable()
        m = _chaos_metric()
        m.update(1.0)
        m.compute()
        obs.counter_inc("weird.name", 2, label_with="quote\"back\\slash\nnewline")
        parsed = obs.parse_prometheus_text(obs.prometheus_text())
        assert parsed
        for (name, labels), value in obs.counters_snapshot().items():
            prom = "metrics_tpu_" + name.replace(".", "_") + "_total"
            assert parsed[(prom, tuple((k, str(v)) for k, v in labels))] == pytest.approx(value)
        span_series = [k for k in parsed if k[0] == "metrics_tpu_span_count_total"]
        assert span_series and all(dict(labels).get("span") for _, labels in span_series)

    def test_parse_rejects_malformed_lines(self):
        with pytest.raises(ValueError):
            obs.parse_prometheus_text("metrics_tpu_x_total{a=unquoted} 1")
        with pytest.raises(ValueError):
            obs.parse_prometheus_text('metrics_tpu_x_total{a="unterminated} 1')

    def test_dump_json_writes_valid_report(self, tmp_path):
        obs.enable()
        m = mt.Accuracy(num_classes=3, device="cpu")
        m.update(torch.tensor([0, 1, 2]), torch.tensor([0, 1, 1]))
        m.compute()
        path = tmp_path / "obs.json"
        assert obs.dump_json(str(path)) == str(path)
        data = json.loads(path.read_text())
        assert data["enabled"] is True
        assert any(s["name"] == "metric.update" for s in data["spans"])

    def test_summarize_counters_accepts_delta(self):
        obs.counter_inc("sync.reports", 2, metric="A")
        before = obs.counters_snapshot()
        obs.counter_inc("sync.reports", 3, metric="A")
        after = obs.counters_snapshot()
        delta = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
        assert obs.summarize_counters(delta) == {"sync": {"reports": 3}}


# ------------------------------------------------------------------ warn_once
class TestWarnOnce:
    def test_emits_once_then_suppresses_and_counts(self):
        with pytest.warns(UserWarning, match="thing happened"):
            assert warn_once("thing happened", key="test.thing") is True
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert warn_once("thing happened", key="test.thing") is False
            assert warn_once("thing happened", key="test.thing") is False
        assert obs.counter_value("warn_once.suppressed", site="test.thing") == 2
        assert obs.counter_value("warn_once.emitted", site="test.thing") == 1

    def test_distinct_keys_warn_independently(self):
        with pytest.warns(UserWarning):
            warn_once("msg", key="test.k1")
        with pytest.warns(UserWarning):
            warn_once("msg", key="test.k2")

    def test_reset_clears_dedup_registry(self):
        with pytest.warns(UserWarning):
            warn_once("again", key="test.reset")
        obs.reset()
        with pytest.warns(UserWarning):
            warn_once("again", key="test.reset")

    def test_prints_reexports_the_counting_warn_once(self):
        from metrics_tpu_torch.utils import prints

        assert prints.warn_once is warn_once

    def test_r2_degenerate_routes_through_warn_once(self):
        from metrics_tpu_torch.functional.regression.r2 import r2_score

        preds = torch.tensor([1.0, 2.0, 3.0])
        with pytest.warns(UserWarning, match="More independent regressions"):
            r2_score(preds, preds.clone(), adjusted=5)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            r2_score(preds, preds.clone(), adjusted=5)
        assert obs.counter_value("warn_once.suppressed", site="r2.adjusted_degenerate") == 1


# -------------------------------------------------------- sync-report history
class TestSyncReportHistory:
    def test_history_ring_bounded_at_16(self):
        m = _chaos_metric()
        for i in range(20):
            m.update(float(i))
            m.compute()
            m._computed = None
        assert len(m.sync_report_history) == 16
        assert m.sync_report_history[-1] == m.last_sync_report
        assert len(obs.sync_reports("DummyMetricSum")) == 20

    def test_registry_queryable_by_metric(self):
        m = _chaos_metric()
        m.update(1.0)
        m.compute()
        reports = obs.sync_reports("DummyMetricSum")
        assert reports and reports[-1]["backend"] == "ChaosBackend"
        assert obs.sync_reports("NoSuchMetric") == []
        assert obs.counter_value("sync.reports", metric="DummyMetricSum") == 1

    def test_collection_aggregate_sync_report(self):
        def backend():
            return tp.ChaosBackend(tp.NullBackend(), world_size=2, options=tp.SyncOptions(timeout=None))

        mc = mt.MetricCollection(
            {"a": DummyMetricSum(sync_backend=backend()), "b": DummyMetricSum(sync_backend=backend())},
            compute_groups=False,
            device="cpu",
        )
        mc.update(2.0)
        mc.compute()
        agg = mc.aggregate_sync_report()
        assert agg["members_reporting"] == 2
        assert agg["gather_calls"] > 0 and agg["bytes_gathered"] > 0
        assert agg["errors"] == [] and agg["overlap_secs"] == 0.0
        assert all(len(v) == 1 for v in mc.sync_report_history.values())


# ------------------------------------------------------------------- parity
def _run_sequence(pkg, par, make_tensor, **extra):
    """One sequence of the obs parity case, in either package."""
    preds, target = _batch(0)
    acc = pkg.Accuracy(num_classes=C, **extra)
    acc.update(make_tensor(preds), make_tensor(target))
    acc.compute()
    col = pkg.MetricCollection(
        {"acc": pkg.Accuracy(num_classes=C, **extra), "prec": pkg.Precision(num_classes=C, average="macro", **extra)},
        **({"device": "cpu"} if "device" in extra else {}),
    )
    for seed in (1, 2):
        p, t = _batch(seed)
        col.update(make_tensor(p), make_tensor(t))
    col.compute()
    cat = pkg.CatMetric(sync_backend=par.LoopbackBackend(), **extra)
    for step in range(2):
        cat.update(make_tensor(np.arange(4, dtype=np.float32) + 10 * step))
        cat.compute()
    chaos = pkg.SumMetric(
        sync_backend=par.ChaosBackend(par.LoopbackBackend(), schedule={0: "delay"}, delay_secs=0.0), **extra
    )
    chaos.update(make_tensor(np.float32(2.5)))
    chaos.compute()


def _comparable(snapshot):
    return {k: v for k, v in snapshot.items() if k[0] not in NO_COUNTERPART}


class TestParity:
    def test_counters_equal_after_the_same_sequence(self):
        import jax.numpy as jnp

        _run_sequence(jm, jp, jnp.asarray, **EAGER)
        _run_sequence(mt, tp, torch.as_tensor, device="cpu")
        ref = _comparable(jobs.counters_snapshot())
        got = _comparable(obs.counters_snapshot())
        assert got == ref
        # the sequence reached the sync, delta and chaos counters
        names = {name for name, _ in got}
        assert {"sync.reports", "sync.delta_syncs", "sync.full_syncs", "sync.bytes_saved", "chaos.faults"} <= names
        assert obs.summarize_counters() == {
            k: v for k, v in jobs.summarize_counters().items() if k not in ("recompiles", "recompiles_by_metric")
        }

    @pytest.mark.parametrize("with_spans", [False, True], ids=["counters", "counters_and_spans"])
    def test_exporters_byte_equal_for_identical_registries(self, with_spans):
        rng = np.random.default_rng(7)
        for i in range(12):
            name = ["sync.bytes_gathered", "ckpt.saves", "streaming.window_evictions", "serve.forwarder_backoff_secs",
                    "sync.overlap_secs", "warn_once.suppressed", "chaos.faults", "multistream.topk_queries"][i % 8]
            value = float(rng.integers(1, 1000)) if i % 3 else float(rng.random())
            labels = {"metric": f"M{i % 3}", "site": 'q"uo\\te\n'} if i % 2 else {"kind": "stall"}
            for registry in (obs, jobs):
                registry.counter_inc(name, value, **labels)
        if with_spans:
            spans = {("metric.update", (("metric", "Accuracy"),)): [3, 0.125, 0.0625],
                     ("collection.compute", (("members", "2"),)): [1, 1.5e-05, 1.5e-05]}
            from metrics_tpu.obs import core as jcore

            for core in (obs_core, jcore):
                with core._rt.lock:
                    core._rt.spans.update({k: list(v) for k, v in spans.items()})
        assert obs.prometheus_text() == jobs.prometheus_text()
        assert json.dumps(obs.summarize_counters(), sort_keys=True) == json.dumps(jobs.summarize_counters(), sort_keys=True)
        values = {"mse": 0.25, "q": {"p50": float("nan"), "p99": float("inf")}, "t": [({"stream": "3"}, -2.0)]}
        assert obs.metric_values_prometheus_text(values) == jobs.metric_values_prometheus_text(values)
        assert obs.parse_prometheus_text(obs.prometheus_text()) == jobs.parse_prometheus_text(jobs.prometheus_text())

    @pytest.mark.parametrize("value, on", [("1", True), ("on", True), ("0", False), ("", False)])
    def test_environment_switch_is_shared(self, monkeypatch, value, on):
        # a fresh copy of each core module, loaded under METRICS_TPU_OBS=value
        import importlib.util

        from metrics_tpu.obs import core as jcore

        monkeypatch.setenv("METRICS_TPU_OBS", value)
        for i, path in enumerate((obs_core.__file__, jcore.__file__)):
            spec = importlib.util.spec_from_file_location(f"_obs_core_copy{i}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            assert module.enabled() is on
