"""The port's load generator (``metrics_tpu_torch.serve.loadgen``) on the CPU.

Mirrors ``tests/serve/test_loadgen.py`` case for case with ``device="cpu"``:
counter-keyed columnar traffic, thread mode (ingest, query sampling, the
flush inside the timed window) and process mode (stdlib children POSTing
JSON at a live server).  Then against the JAX package: ``ColumnTraffic``'s
batches are byte-equal to the JAX one's for the same seed and window,
dyadic or not, and the port's own copy of the child script makes the same
records as the JAX one's.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from metrics_tpu.serve import ColumnTraffic as JColumnTraffic
from metrics_tpu_torch.multistream import MultiStreamMetric
from metrics_tpu_torch.obs import counter_value
from metrics_tpu_torch.regression import MeanSquaredError
from metrics_tpu_torch.serve import (
    ColumnTraffic,
    EvalServer,
    MetricRegistry,
    ServeConfig,
    run_load,
    run_process_load,
)
from metrics_tpu_torch.serve import loadgen
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

S = 8
ROOT = Path(__file__).resolve().parents[1]


def _server():
    registry = MetricRegistry()
    registry.register("tenants", MultiStreamMetric(MeanSquaredError(device="cpu"), num_streams=S, device="cpu"))
    return EvalServer(registry, ServeConfig(block_rows=8, flush_interval=3600.0)).start()


class TestColumnTraffic:
    def test_batches_are_pure_in_seed_and_offset(self):
        a = ColumnTraffic("mse", arity=2, num_streams=S, seed=3)
        b = ColumnTraffic("mse", arity=2, num_streams=S, seed=3)
        cols_a, ids_a = a.batch(100, 164)
        cols_b, ids_b = b.batch(100, 164)
        for x, y in zip(cols_a, cols_b):
            assert np.array_equal(x, y)
        assert np.array_equal(ids_a, ids_b)
        # a different window is genuinely different traffic
        cols_c, _ = a.batch(164, 228)
        assert not np.array_equal(cols_a[0], cols_c[0])
        # ...and a different seed too
        cols_d, _ = ColumnTraffic("mse", arity=2, num_streams=S, seed=4).batch(100, 164)
        assert not np.array_equal(cols_a[0], cols_d[0])

    def test_batch_is_stateless(self):
        # the generator is counter-keyed by the batch's lo: interleaving
        # other draws between calls cannot perturb a window's contents
        t = ColumnTraffic("mse", arity=2, num_streams=S, seed=9)
        first_cols, first_ids = t.batch(64, 128)
        t.batch(0, 8192)  # unrelated draw in between
        again_cols, again_ids = t.batch(64, 128)
        for x, y in zip(first_cols, again_cols):
            assert np.array_equal(x, y)
        assert np.array_equal(first_ids, again_ids)

    def test_plain_job_has_no_ids(self):
        cols, ids = ColumnTraffic("mse", arity=2).batch(0, 10)
        assert ids is None and len(cols) == 2

    def test_multistream_ids_stay_in_range(self):
        _cols, ids = ColumnTraffic("t", arity=2, num_streams=S).batch(0, 500)
        assert ids.min() >= 0 and ids.max() < S

    def test_rejects_empty_windows(self):
        with pytest.raises(MetricsTPUUserError):
            ColumnTraffic("t").batch(5, 5)


class TestRunLoad:
    def test_report_counts_and_flush_in_window(self):
        srv = _server()
        traffic = ColumnTraffic("tenants", arity=2, num_streams=S, seed=1)
        flushed = []

        def ingest(lo, hi):
            cols, ids = traffic.batch(lo, hi)
            ok = srv.submit_columns("tenants", cols, stream_ids=ids)
            return (hi - lo, 0) if ok else (0, hi - lo)

        runs_before = counter_value("serve.loadgen_runs")
        report = run_load(
            ingest,
            total_records=200,
            batch_rows=64,
            threads=2,
            query=lambda: srv.registry["tenants"].top_k(2),
            flush=lambda: flushed.append(srv.flush(10.0)) or flushed[-1],
        )
        assert report.records == 200
        assert report.accepted == 200 and report.rejected == 0
        assert report.errors == []
        assert report.elapsed_s > 0 and report.records_per_s > 0
        assert report.query_count > 0 and report.query_errors == 0
        assert report.query_p99_ms >= report.query_p50_ms > 0
        assert flushed == [True]  # flush ran, inside the timed window
        assert counter_value("serve.loadgen_runs") == runs_before + 1
        # the flush means throughput measured applied state: all 200 rows
        # are readable now
        values = np.asarray(srv.registry["tenants"].compute_streams(list(range(S))))
        assert not np.isnan(values).any()
        srv.stop(final_checkpoint=False)

    def test_ingest_exceptions_become_report_errors(self):
        def ingest(lo, hi):
            if lo >= 64:
                raise RuntimeError("backend down")
            return hi - lo, 0

        report = run_load(ingest, total_records=128, batch_rows=64)
        assert report.accepted == 64
        assert len(report.errors) == 1 and "backend down" in report.errors[0]

    def test_rejects_empty_runs(self):
        with pytest.raises(MetricsTPUUserError):
            run_load(lambda lo, hi: (0, 0), total_records=0)


class TestRunProcessLoad:
    def test_children_post_over_http(self):
        srv = _server()
        try:
            report = run_process_load(
                f"http://127.0.0.1:{srv.port}",
                "tenants",
                total_records=96,
                processes=2,
                batch_rows=32,
                num_streams=S,
            )
            assert report.records == 96
            assert report.accepted == 96 and report.rejected == 0
            assert report.errors == []
            assert srv.flush(10.0)
            values = np.asarray(srv.registry["tenants"].compute_streams(list(range(S))))
            assert not np.isnan(values).any()
        finally:
            srv.stop(final_checkpoint=False)

    def test_children_run_the_ports_own_script(self):
        assert Path(loadgen._CHILD_PATH) == ROOT / "metrics_tpu_torch" / "serve" / "_loadgen_child.py"


def _load_child(path):
    spec = importlib.util.spec_from_file_location(f"child_{path.parent.parent.name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class TestParityWithJax:
    @pytest.mark.parametrize("num_streams", [None, S, 1000])
    @pytest.mark.parametrize("dyadic", [False, True])
    def test_batches_are_the_jax_bytes(self, num_streams, dyadic):
        for seed, arity, (lo, hi) in ((0, 2, (0, 64)), (21, 2, (600, 664)), (7, 1, (12345, 20000))):
            ours = ColumnTraffic("t", arity=arity, num_streams=num_streams, seed=seed, dyadic=dyadic).batch(lo, hi)
            theirs = JColumnTraffic("t", arity=arity, num_streams=num_streams, seed=seed, dyadic=dyadic).batch(lo, hi)
            assert len(ours[0]) == len(theirs[0]) == arity
            for x, y in zip(ours[0], theirs[0]):
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
            if num_streams is None:
                assert ours[1] is None and theirs[1] is None
            else:
                assert ours[1].dtype == theirs[1].dtype and ours[1].tobytes() == theirs[1].tobytes()

    def test_children_make_the_jax_records(self):
        ours = _load_child(ROOT / "metrics_tpu_torch" / "serve" / "_loadgen_child.py")
        theirs = _load_child(ROOT / "metrics_tpu" / "serve" / "_loadgen_child.py")
        for args in ((0, 0, 50, 2, 0), (3, 100, 164, 2, S), (9, 7, 20, 3, 1000)):
            assert ours.make_batch(*args) == theirs.make_batch(*args)
