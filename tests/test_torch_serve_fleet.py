"""The port's sharded fleet (``metrics_tpu_torch.serve.{coordinator,fleet}``) on the CPU.

Mirrors ``tests/serve/test_fleet.py`` case for case with ``device="cpu"``:
two in-process workers behind one coordinator, the span partition, the
scatter-gather merges bitwise against one worker over the whole stream axis
(dyadic rows, so float32 sums are exact however blocks fall), the failover
drill, the HTTP frontend and the serve counters.

The counters case compares deltas.  The JAX test compares the summary's
``shard_routes`` (every ``shard`` label the process ever counted) with the
sum of shards 0 and 1 alone, so an earlier fleet of three or more shards in
the same process breaks it (``tests/serve/test_fleet_resize.py`` run before
it fails it every time); here the summary's growth over the test is held to
the growth of the fleet's own shards' counts.  Last, the port's device
rules: a fleet runs on ``"cuda"`` unless asked for ``"cpu"`` and raises
without CUDA, and a job built on another device than the fleet's raises.
"""

import types

import numpy as np
import pytest
import torch

from metrics_tpu_torch.obs import counter_value, parse_prometheus_text, prometheus_text, summarize_counters
from metrics_tpu_torch.serve import FleetSpec, JobSpec, LocalFleet, build_shard_registry
from metrics_tpu_torch.serve.fleet import build_router
from metrics_tpu_torch.serve.soak import trees_bitwise_equal
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from tests.torch_fleet_common import CPU_MSE, dyadic_batch, feed, fleet_spec, frontend, get_json, make_fleets, stop_all, post_json  # noqa: F401

S = 8


@pytest.fixture
def fleets():
    make, alive = make_fleets(lambda n, root: fleet_spec(n, S, root))
    yield make
    stop_all(alive)


class TestShardPartition:
    def test_registries_partition_the_stream_axis(self, fleets):
        fleet = fleets(2)
        widths = []
        plain_hosts = []
        for shard in range(2):
            registry = fleet.server(shard).registry
            widths.append(registry["tenants"].metric.num_streams)
            plain_hosts.append("mse" in registry)
        assert sum(widths) == S
        assert widths == [fleet.router.span_width("tenants", s) for s in range(2)]
        # the plain job lives on exactly the ring-owned shard
        assert plain_hosts.count(True) == 1
        assert plain_hosts.index(True) == fleet.router.owner("mse")
        assert all(fleet.server(s).registry.device == torch.device("cpu") for s in range(2))

    def test_rows_land_on_their_span(self, fleets):
        fleet = fleets(2)
        lo, hi = fleet.router.span("tenants", 1)
        sids = np.arange(lo, hi, dtype=np.int64)
        cols = [np.ones(len(sids), np.float32), np.zeros(len(sids), np.float32)]
        fleet.coordinator.ingest_columns("tenants", cols, sids)
        assert fleet.coordinator.flush(10.0)
        values = fleet.server(1).registry["tenants"].compute_streams(list(range(hi - lo)))
        assert all(float(v) == 1.0 for v in np.asarray(values))
        # shard 0's spans saw nothing
        other = np.asarray(
            fleet.server(0).registry["tenants"].compute_streams(list(range(fleet.router.span_width("tenants", 0))))
        )
        assert np.isnan(other).all()


class TestScatterGather:
    def test_merges_match_single_worker_bitwise(self, fleets):
        fleet, solo = fleets(2), fleets(1)
        for coord in (fleet.coordinator, solo.coordinator):
            feed(coord, 150)
            # engineer a tie: streams 1 and 4 get one identical extra row
            coord.ingest_columns("tenants", [np.float32([1.0, 1.0]), np.float32([0.5, 0.5])], np.int64([1, 4]))
            assert coord.flush(10.0)

        assert trees_bitwise_equal(fleet.coordinator.compute_all(), solo.coordinator.compute_all())
        ids = [5, 0, 3, 1]
        assert trees_bitwise_equal(
            fleet.coordinator.compute_streams("tenants", ids), solo.coordinator.compute_streams("tenants", ids)
        )
        for k in (1, 3, 6):
            for largest in (True, False):
                assert fleet.coordinator.top_k("tenants", k, largest=largest) == solo.coordinator.top_k(
                    "tenants", k, largest=largest
                )
        for op, threshold in (("ge", 0.25), ("lt", 1.0), ("gt", 100.0)):
            assert fleet.coordinator.where("tenants", op, threshold, k=S) == solo.coordinator.where(
                "tenants", op, threshold, k=S
            )

    def test_untouched_streams_rank_last_and_never_match(self, fleets):
        fleet = fleets(2)
        feed(fleet.coordinator, 60, streams=6)  # streams 6, 7 untouched
        assert fleet.coordinator.flush(10.0)
        values, ids = fleet.coordinator.top_k("tenants", S)
        assert set(ids) == set(range(S))
        assert ids[-2:] == [6, 7]  # NaN sinks, id breaks the tie
        assert all(np.isnan(v) for v in values[-2:])
        matched, total = fleet.coordinator.where("tenants", "ge", -1e9, k=S)
        assert 6 not in matched and 7 not in matched
        assert total == 6

    def test_stream_id_validation(self, fleets):
        fleet = fleets(2)
        with pytest.raises(MetricsTPUUserError):
            fleet.coordinator.compute_streams("tenants", [S])
        with pytest.raises(MetricsTPUUserError):
            fleet.coordinator.top_k("tenants", S + 1)

    def test_ingest_records_scalar_path_matches_columns(self, fleets):
        fleet, twin = fleets(2), fleets(2)
        preds, targets, sids = dyadic_batch(40)
        records = [((float(p), float(t)), int(s)) for p, t, s in zip(preds, targets, sids)]
        accepted, rejected = fleet.coordinator.ingest_records("tenants", records)
        assert (accepted, rejected) == (40, 0)
        twin.coordinator.ingest_columns("tenants", [preds, targets], sids)
        assert fleet.coordinator.flush(10.0) and twin.coordinator.flush(10.0)
        assert trees_bitwise_equal(fleet.coordinator.compute("tenants"), twin.coordinator.compute("tenants"))

    def test_ingest_records_rejects_missing_stream_ids(self, fleets):
        fleet = fleets(2)
        accepted, rejected = fleet.coordinator.ingest_records("tenants", [((1.0, 0.5), 2), ((1.0, 0.5), None)])
        assert (accepted, rejected) == (1, 1)


class TestFailover:
    def test_kill_failover_restores_bitwise(self, fleets, tmp_path):
        fleet = fleets(2, checkpoint_root=str(tmp_path / "fleet"))
        twin = fleets(2, checkpoint_root=str(tmp_path / "twin"))

        # identical cadence on both fleets: feed, flush, checkpoint; only the
        # kill/failover differs, so compute_all must match bitwise
        for f in (fleet, twin):
            feed(f.coordinator, 70)
            assert f.coordinator.flush(10.0)
            steps = f.checkpoint_all()
            assert set(steps) == {0, 1}

        victim = fleet.router.shard_for("tenants", 0)
        fleet.kill_shard(victim)
        assert fleet.coordinator.health()["status"] == "degraded"

        failovers_before = counter_value("serve.failovers", shard=str(victim))
        for f in (fleet, twin):
            feed(f.coordinator, 50, lo=70)  # victim's rows park in its ring
        fleet.failover(victim)
        assert counter_value("serve.failovers", shard=str(victim)) == failovers_before + 1
        for f in (fleet, twin):
            assert f.coordinator.flush(10.0)

        assert fleet.coordinator.health()["status"] == "serving"
        assert trees_bitwise_equal(fleet.coordinator.compute_all(), twin.coordinator.compute_all())

    def test_health_rollup_names_dead_shards(self, fleets):
        fleet = fleets(2)
        assert fleet.coordinator.health()["dead_shards"] == []
        fleet.kill_shard(0)
        info = fleet.coordinator.health()
        assert info["status"] == "degraded"
        assert info["dead_shards"] == [0]


class TestHTTPFrontend:
    def test_roundtrip_and_healthz_degradation(self, fleets, frontend):
        fleet = fleets(2)
        port = frontend(fleet)

        # touch every stream and both jobs: JSON round-trips NaN as the
        # canonical quiet NaN, which need not match the device's bit pattern
        batch = dyadic_batch(30, streams=8)
        records = [{"values": [float(p), float(t)], "stream_id": int(s)} for p, t, s in zip(*batch)]
        out = post_json(port, "/ingest", {"job": "tenants", "records": records})
        assert out == {"accepted": 30, "rejected": 0}
        plain = [{"values": r["values"]} for r in records]
        out = post_json(port, "/ingest", {"job": "mse", "records": plain})
        assert out == {"accepted": 30, "rejected": 0}
        assert fleet.coordinator.flush(10.0)

        expected_values, expected_ids = fleet.coordinator.top_k("tenants", 3)
        out = get_json(port, "/query?job=tenants&top_k=3")
        assert out["stream_ids"] == expected_ids
        assert out["top_k"] == expected_values

        out = get_json(port, "/query?job=tenants&streams=2,0")
        assert trees_bitwise_equal(out["values"], fleet.coordinator.compute_streams("tenants", [2, 0]))
        out = get_json(port, "/query?job=tenants&where=ge:0.25&k=8")
        ids, total = fleet.coordinator.where("tenants", "ge", 0.25, k=8)
        assert (out["stream_ids"], out["total_matches"]) == (ids, total)

        out = get_json(port, "/compute_all")
        assert trees_bitwise_equal(out["values"], fleet.coordinator.compute_all())

        get_json(port, "/query?job=nope", expect=404)
        post_json(port, "/ingest", {"job": "tenants", "records": [{"values": []}]}, expect=400)

        assert get_json(port, "/healthz")["status"] == "serving"
        fleet.kill_shard(1)
        assert get_json(port, "/healthz", expect=503)["status"] == "degraded"
        fleet.failover(1)
        assert get_json(port, "/healthz")["status"] == "serving"


SCATTER_OPS = ("top_k", "compute", "compute_streams", "where")


def _routes(shards):
    return {s: counter_value("serve.shard_routes", shard=str(s)) for s in shards}


class TestServeCounters:
    def test_counters_surface_and_roundtrip(self, fleets, frontend):
        scatter_before = sum(counter_value("serve.scatter_queries", op=op) for op in SCATTER_OPS)
        busy_before = counter_value("serve.frontend_threads_busy")
        summary_routes_before = summarize_counters().get("serve", {}).get("shard_routes", 0)

        fleet = fleets(2)
        shards = range(fleet.coordinator.num_shards)
        routes_before = _routes(shards)
        port = frontend(fleet)
        feed(fleet.coordinator, 40)
        assert fleet.coordinator.flush(10.0)
        get_json(port, "/query?job=tenants&top_k=2")
        fleet.coordinator.compute_all()

        routes_after = _routes(shards)
        grown = {s: routes_after[s] - routes_before[s] for s in shards}
        assert sum(grown.values()) > 0
        # a fresh frontend pool records its first high-water mark
        assert counter_value("serve.frontend_threads_busy") > busy_before
        scatter = sum(counter_value("serve.scatter_queries", op=op) for op in SCATTER_OPS)
        assert scatter > scatter_before

        # the summary folds every shard label the process ever counted: its
        # growth over this test is the growth of this fleet's own shards
        summary = summarize_counters()
        assert summary["serve"]["shard_routes"] - summary_routes_before == int(sum(grown.values()))
        assert summary["serve"]["scatter_queries"] >= 1
        assert "failovers" in summarize_counters({("serve.failovers", (("shard", "0"),)): 2.0}).get("serve", {})

        parsed = parse_prometheus_text(prometheus_text())
        for shard in shards:
            key = ("metrics_tpu_serve_shard_routes_total", (("shard", str(shard)),))
            assert parsed[key] == counter_value("serve.shard_routes", shard=str(shard))
        busy_key = ("metrics_tpu_serve_frontend_threads_busy_total", ())
        assert parsed[busy_key] == counter_value("serve.frontend_threads_busy")


class TestDevices:
    def test_a_fleet_without_device_raises_when_cuda_is_absent(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        jobs = [JobSpec("mse", CPU_MSE)]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            FleetSpec(num_shards=1, jobs=jobs)
        assert FleetSpec(num_shards=1, jobs=jobs, device="cpu").device == "cpu"

    def test_a_job_built_on_another_device_raises(self):
        other = JobSpec("elsewhere", lambda: types.SimpleNamespace(device=torch.device("meta")), num_streams=4)
        spec = FleetSpec(num_shards=1, jobs=[JobSpec("mse", CPU_MSE), other], device="cpu")
        with pytest.raises(MetricsTPUUserError, match="builds a metric on meta"):
            build_shard_registry(spec, 0, build_router(spec))
        plain = FleetSpec(num_shards=1, jobs=[JobSpec("elsewhere", other.build)], device="cpu")
        with pytest.raises(MetricsTPUUserError, match="fleet serves on cpu"):
            LocalFleet(plain).start()
