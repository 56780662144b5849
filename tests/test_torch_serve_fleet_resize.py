"""Elastic resize of the port's fleet (``FleetCoordinator.resize``, ``LocalFleet.resize``) on the CPU.

Mirrors ``tests/serve/test_fleet_resize.py`` case for case with
``device="cpu"``: live grow and shrink against never-resized twins, queries
across the epoch flip, a kill mid-migration then failover and a retried
resize, a flush racing a migration, and the resize counters and ring
statistics the autoscaler reads; then a resized multistream ``Accuracy``
answers before its next rows (the span carries its input mode).  Every drill feeds dyadic rows (multiples of
1/8), so float32 sums are exact wherever block or migration boundaries fall,
and a resized fleet equals its twin BITWISE (float64 bit patterns).
"""

import functools
import threading
import time

import numpy as np
import pytest

from metrics_tpu_torch.obs import core as _obs
from metrics_tpu_torch.classification import Accuracy
from metrics_tpu_torch.obs import counter_value, parse_prometheus_text, prometheus_text, summarize_counters
from metrics_tpu_torch.serve import (
    Autoscaler,
    AutoscalerConfig,
    FleetSignals,
    FleetSpec,
    JobSpec,
    LocalFleet,
    ServeConfig,
    autoscale_step,
)
from metrics_tpu_torch.serve.soak import trees_bitwise_equal
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
from tests.torch_fleet_common import dyadic_batch, fleet_spec, make_fleets, stop_all

S = 16


def feed(coordinator, n, lo=0):
    preds, targets, sids = dyadic_batch(n, lo=lo, streams=S)
    accepted, rejected = coordinator.ingest_columns("tenants", [preds, targets], sids)
    assert rejected == 0 and accepted == n
    accepted, rejected = coordinator.ingest_columns("mse", [preds, targets])
    assert rejected == 0 and accepted == n
    return n


@pytest.fixture
def fleets():
    make, alive = make_fleets(lambda n, root: fleet_spec(n, S, root, export_top_k=3))
    yield make
    stop_all(alive)


def _settled_compute_all(fleet):
    assert fleet.coordinator.flush(timeout=30.0)
    return fleet.coordinator.compute_all()


class TestResizeBitwise:
    def test_grow_matches_never_resized_twin(self, fleets):
        resized, twin = fleets(2), fleets(4)
        for lo in range(0, 120, 24):
            feed(resized.coordinator, 24, lo=lo)
            feed(twin.coordinator, 24, lo=lo)
        phases = []
        summary = resized.resize(4, phase_hook=phases.append)
        assert summary["old_shards"] == 2 and summary["new_shards"] == 4
        assert summary["epoch"] == 1 and summary["drained"]
        assert phases == [
            "planned",
            "provisioned",
            "held",
            "quiesced",
            "staged",
            "flipped",
            "committed",
            "released",
            "drained",
        ]
        for lo in range(120, 200, 16):
            feed(resized.coordinator, 16, lo=lo)
            feed(twin.coordinator, 16, lo=lo)
        assert trees_bitwise_equal(
            _settled_compute_all(resized), _settled_compute_all(twin)
        )
        assert resized.coordinator.num_shards == 4
        assert resized.router.epoch == 1
        assert len(resized._servers) == 4

    def test_shrink_matches_never_resized_twin(self, fleets):
        resized, twin = fleets(4), fleets(3)
        for lo in range(0, 96, 24):
            feed(resized.coordinator, 24, lo=lo)
            feed(twin.coordinator, 24, lo=lo)
        summary = resized.resize(3)
        assert summary["new_shards"] == 3 and summary["rows_moved"] > 0
        for lo in range(96, 160, 16):
            feed(resized.coordinator, 16, lo=lo)
            feed(twin.coordinator, 16, lo=lo)
        assert trees_bitwise_equal(
            _settled_compute_all(resized), _settled_compute_all(twin)
        )
        assert len(resized._servers) == 3

    def test_queries_keep_flowing_across_the_flip(self, fleets):
        fleet = fleets(2)
        feed(fleet.coordinator, 64)
        assert fleet.coordinator.flush(timeout=30.0)
        stop = threading.Event()
        failures = []

        def reader():
            while not stop.is_set():
                try:
                    value = fleet.coordinator.compute("tenants")
                    assert len(value) == S
                except Exception as err:  # noqa: BLE001 — collected, not raised
                    failures.append(err)

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        try:
            fleet.resize(4)
            fleet.resize(3)
        finally:
            stop.set()
            t.join(timeout=10.0)
        assert failures == []

    def test_resize_validation(self, fleets):
        fleet = fleets(2)
        with pytest.raises(MetricsTPUUserError):
            fleet.coordinator.resize(0)
        coordinator = fleet.coordinator
        coordinator._provision = None
        with pytest.raises(MetricsTPUUserError):
            coordinator.resize(4)  # grow without a provision callback


class TestKillStorm:
    def test_kill_mid_migration_then_failover_retry_is_lossless(
        self, fleets, tmp_path
    ):
        resized = fleets(2, checkpoint_root=str(tmp_path / "a"))
        twin = fleets(2, checkpoint_root=str(tmp_path / "b"))
        fed = 0
        for lo in range(0, 96, 24):
            feed(resized.coordinator, 24, lo=lo)
            feed(twin.coordinator, 24, lo=lo)
            fed += 24
        assert resized.coordinator.flush(timeout=30.0)

        victim = 0

        def storm(phase):
            # the durability floor has just landed (LocalFleet checkpoints
            # every shard before reporting "quiesced"): a SIGKILL here is
            # the worst pre-flip moment — state is about to be exported
            if phase == "quiesced":
                resized.kill_shard(victim)

        with pytest.raises(MetricsTPUUserError):
            resized.resize(4, phase_hook=storm)

        # pre-flip abort: the old epoch is intact and nothing is held
        stats = resized.coordinator.ring_stats()
        assert stats["epoch"] == 0 and stats["num_shards"] == 2
        assert stats["held_jobs"] == [] and not stats["resizing"]
        assert counter_value("serve.resize_failures") >= 1

        # rows accepted while the victim is down park in its rings
        parked_before = counter_value("serve.parked_rows")
        feed(resized.coordinator, 24, lo=96)
        feed(twin.coordinator, 24, lo=96)
        deadline = time.monotonic() + 10.0
        while counter_value("serve.parked_rows") == parked_before:
            assert time.monotonic() < deadline, "rows never parked"
            time.sleep(0.01)

        resized.failover(victim)
        summary = resized.resize(4)  # retry against the restored worker
        assert summary["new_shards"] == 4 and summary["epoch"] == 1

        for lo in range(120, 168, 24):
            feed(resized.coordinator, 24, lo=lo)
            feed(twin.coordinator, 24, lo=lo)
        assert trees_bitwise_equal(
            _settled_compute_all(resized), _settled_compute_all(twin)
        )

    def test_resize_storm_2_4_3_with_kill_is_bitwise(self, fleets, tmp_path):
        resized = fleets(2, checkpoint_root=str(tmp_path / "a"))
        twin = fleets(3, checkpoint_root=str(tmp_path / "b"))
        lo = 0
        for _ in range(4):
            feed(resized.coordinator, 24, lo=lo)
            feed(twin.coordinator, 24, lo=lo)
            lo += 24
        resized.resize(4)
        for _ in range(2):
            feed(resized.coordinator, 24, lo=lo)
            feed(twin.coordinator, 24, lo=lo)
            lo += 24

        killed = []

        def storm(phase):
            if phase == "quiesced" and not killed:
                killed.append(1)
                resized.kill_shard(3)

        with pytest.raises(MetricsTPUUserError):
            resized.resize(3, phase_hook=storm)
        resized.failover(3)
        summary = resized.resize(3)
        assert summary["new_shards"] == 3 and summary["epoch"] == 2

        for _ in range(2):
            feed(resized.coordinator, 24, lo=lo)
            feed(twin.coordinator, 24, lo=lo)
            lo += 24
        assert trees_bitwise_equal(
            _settled_compute_all(resized), _settled_compute_all(twin)
        )


class TestFlushDuringMigration:
    def test_flush_waits_for_parked_rows_to_drain(self, fleets):
        """Satellite regression: ``flush`` during a migration must not
        report success while held rows are still parked in the rings."""
        fleet = fleets(2)
        feed(fleet.coordinator, 48)
        assert fleet.coordinator.flush(timeout=30.0)

        stall = threading.Event()
        staged = threading.Event()

        def hook(phase):
            if phase == "staged":
                staged.set()
                assert stall.wait(timeout=30.0)

        errors = []

        def run_resize():
            try:
                fleet.resize(4, phase_hook=hook)
            except Exception as err:  # noqa: BLE001 — surfaced via the list
                errors.append(err)

        t = threading.Thread(target=run_resize, daemon=True)
        t.start()
        assert staged.wait(timeout=30.0)
        # mid-migration: new rows for the held job park in the rings
        feed(fleet.coordinator, 24, lo=48)
        assert fleet.coordinator.ring_stats()["staged_rows"] > 0
        # a flush racing the migration must time out, not lie
        assert fleet.coordinator.flush(timeout=0.3) is False
        stall.set()
        t.join(timeout=30.0)
        assert not t.is_alive() and errors == []
        # once the migration settles, flush drains the parked rows for real
        assert fleet.coordinator.flush(timeout=30.0)
        assert fleet.coordinator.ring_stats()["staged_rows"] == 0


class TestResizeObservability:
    def test_counters_roundtrip_through_prometheus(self, fleets):
        fleet = fleets(2)
        feed(fleet.coordinator, 48)
        fleet.resize(3)
        assert fleet.coordinator.flush(timeout=30.0)
        # the backoff counter is float-valued; exercise its export path
        # even when no forwarder erred during this test run
        _obs.counter_inc("serve.forwarder_backoff_secs", 0.015625, shard="0")
        _obs.counter_inc("serve.shard_retries")

        assert counter_value("serve.resizes") >= 1
        assert counter_value("serve.ring_occupancy_hwm") > 0

        summary = summarize_counters()
        serve = summary["serve"]
        assert serve["resizes"] >= 1
        assert isinstance(serve["ring_occupancy_hwm"], int)
        assert isinstance(serve["shard_retries"], int)
        assert isinstance(serve["forwarder_backoff_secs"], float)

        parsed = parse_prometheus_text(prometheus_text())
        by_name = {}
        for (name, _labels), value in parsed.items():
            by_name[name] = by_name.get(name, 0.0) + value
        assert by_name["metrics_tpu_serve_resizes_total"] >= 1
        assert by_name["metrics_tpu_serve_ring_occupancy_hwm_total"] > 0
        assert by_name["metrics_tpu_serve_shard_retries_total"] >= 1
        assert (
            by_name["metrics_tpu_serve_forwarder_backoff_secs_total"]
            >= 0.015625
        )

    def test_ring_stats_feed_the_autoscaler(self, fleets):
        fleet = fleets(2)
        feed(fleet.coordinator, 48)
        scaler = Autoscaler(AutoscalerConfig(max_shards=4, hysteresis=1))
        stats = fleet.coordinator.ring_stats()
        assert stats["num_shards"] == 2 and not stats["resizing"]
        target, signals = autoscale_step(scaler, stats)
        assert signals.num_shards == 2
        assert 0.0 <= signals.occupancy <= 1.0
        # a saturated observation recommends exactly one step up
        hot = FleetSignals(num_shards=2, occupancy=1.0, backoff_secs=0.0)
        scaler.observe(hot)
        assert scaler.recommend() == 3


class TestResizeCarriesInputMode:
    def test_a_resized_accuracy_answers_before_its_next_rows(self):
        """A span carries its donor's input ``mode`` (the port's ``"extra"`` field of the span payload): a
        multistream ``Accuracy`` answers right after a resize, bitwise a never-resized twin.  The JAX package's
        span payload drops the mode, and its recipients raise until new rows arrive."""
        c = 10

        def spec(n):
            build = functools.partial(Accuracy, num_classes=c, device="cpu")
            return FleetSpec(num_shards=n, jobs=[JobSpec("per_class", build, num_streams=c)], ingest_dtype=np.int32,
                             server_config=ServeConfig(block_rows=16, flush_interval=3600.0), device="cpu")

        rng = np.random.default_rng(3)
        labels = rng.integers(0, c, 120).astype(np.int32)
        preds = np.where(rng.random(120) < 0.6, labels, rng.integers(0, c, 120)).astype(np.int32)
        fleets = [LocalFleet(spec(n)).start() for n in (2, 3)]
        try:
            for f in fleets:
                assert f.coordinator.ingest_columns("per_class", [preds, labels], labels) == (120, 0)
                assert f.coordinator.flush(30.0)
            before = fleets[0].coordinator.compute("per_class")
            summary = fleets[0].resize(3)
            assert summary["rows_moved"] > 0
            after = fleets[0].coordinator.compute("per_class")
            assert trees_bitwise_equal(after, before)
            assert trees_bitwise_equal(after, fleets[1].coordinator.compute("per_class"))
        finally:
            stop_all(fleets)
