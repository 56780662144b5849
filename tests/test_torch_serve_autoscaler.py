"""The port's autoscaler policy (``metrics_tpu_torch.serve.autoscaler``): signals, hysteresis, clamping.

Mirrors ``tests/serve/test_autoscaler.py`` case for case, then feeds one
seeded sequence of ``ring_stats`` snapshots and counter snapshots to the
port's policy and the JAX package's: every decision and every ``state()``
is the same.
"""

import pytest

import numpy as np

from metrics_tpu import serve as jserve
from metrics_tpu_torch.serve import (
    Autoscaler,
    AutoscalerConfig,
    FleetSignals,
    autoscale_step,
)
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError


def _stats(num_shards=2, depth=0, capacity=100, resizing=False):
    return {
        "num_shards": num_shards,
        "ring_capacity": capacity,
        "rings": [{"shard": 0, "job": "j", "depth": depth}],
        "resizing": resizing,
    }


def _sig(shards=2, occ=0.0, backoff=0.0, resizing=False):
    return FleetSignals(
        num_shards=shards,
        occupancy=occ,
        backoff_secs=backoff,
        resizing=resizing,
    )


class TestConfigValidation:
    def test_rejects_bad_bounds(self):
        with pytest.raises(MetricsTPUUserError):
            AutoscalerConfig(min_shards=0)
        with pytest.raises(MetricsTPUUserError):
            AutoscalerConfig(min_shards=5, max_shards=2)
        with pytest.raises(MetricsTPUUserError):
            AutoscalerConfig(low_occupancy=0.6, high_occupancy=0.5)
        with pytest.raises(MetricsTPUUserError):
            AutoscalerConfig(hysteresis=0)


class TestSignals:
    def test_from_stats_normalizes_occupancy(self):
        sig = FleetSignals.from_stats(_stats(depth=50, capacity=200))
        assert sig.occupancy == 0.25
        assert sig.num_shards == 2 and not sig.resizing

    def test_from_stats_sums_backoff_counter_labels(self):
        counters = {
            ("serve.forwarder_backoff_secs", (("shard", "0"),)): 0.5,
            ("serve.forwarder_backoff_secs", (("shard", "1"),)): 0.25,
            ("serve.fleet_rows_forwarded", (("shard", "0"),)): 999.0,
        }
        sig = FleetSignals.from_stats(_stats(), counters)
        assert sig.backoff_secs == 0.75

    def test_empty_rings_mean_zero_occupancy(self):
        sig = FleetSignals.from_stats({"num_shards": 1, "ring_capacity": 64})
        assert sig.occupancy == 0.0


class TestPolicy:
    def test_grows_only_after_hysteresis(self):
        scaler = Autoscaler(AutoscalerConfig(max_shards=8, hysteresis=3))
        scaler.observe(_sig(occ=0.9))
        assert scaler.recommend() == 2
        scaler.observe(_sig(occ=0.9))
        assert scaler.recommend() == 2
        scaler.observe(_sig(occ=0.9))
        assert scaler.recommend() == 3  # third consecutive hot poll fires

    def test_one_cold_poll_resets_the_hot_streak(self):
        scaler = Autoscaler(AutoscalerConfig(hysteresis=2))
        scaler.observe(_sig(occ=0.9))
        scaler.observe(_sig(occ=0.0))
        scaler.observe(_sig(occ=0.9))
        assert scaler.recommend() == 2  # streak restarted, not accumulated

    def test_backoff_delta_triggers_growth(self):
        scaler = Autoscaler(AutoscalerConfig(hysteresis=2, grow_backoff_secs=0.5))
        scaler.observe(_sig(backoff=10.0))  # first poll: no delta baseline
        scaler.observe(_sig(backoff=11.0))  # +1.0s of fresh backoff: hot
        scaler.observe(_sig(backoff=12.0))
        assert scaler.recommend() == 3

    def test_stale_backoff_total_does_not_block_shrink(self):
        # the counter is monotone: an old incident's accumulated seconds
        # must not read as pressure forever — only the delta counts
        scaler = Autoscaler(AutoscalerConfig(min_shards=1, hysteresis=2))
        scaler.observe(_sig(shards=3, backoff=50.0))
        scaler.observe(_sig(shards=3, backoff=50.0))
        scaler.observe(_sig(shards=3, backoff=50.0))
        assert scaler.recommend() == 2

    def test_shrink_clamps_to_min_and_grow_to_max(self):
        cfg = AutoscalerConfig(min_shards=2, max_shards=3, hysteresis=1)
        scaler = Autoscaler(cfg)
        scaler.observe(_sig(shards=3, occ=0.99))
        assert scaler.recommend() == 3  # already at max: no recommendation
        scaler = Autoscaler(cfg)
        scaler.observe(_sig(shards=2, occ=0.0))
        assert scaler.recommend() == 2  # already at min

    def test_resizing_observations_are_ignored(self):
        scaler = Autoscaler(AutoscalerConfig(hysteresis=2))
        scaler.observe(_sig(occ=0.9))
        scaler.observe(_sig(occ=0.9, resizing=True))  # self-inflicted load
        scaler.observe(_sig(occ=0.9))
        assert scaler.recommend() == 3  # streak survived the resize poll

    def test_recommendation_resets_streaks(self):
        scaler = Autoscaler(AutoscalerConfig(hysteresis=2))
        scaler.observe(_sig(occ=0.9))
        scaler.observe(_sig(occ=0.9))
        assert scaler.recommend() == 3
        assert scaler.recommend() == 2  # must re-earn the next step

    def test_autoscale_step_roundtrip(self):
        scaler = Autoscaler(AutoscalerConfig(hysteresis=1))
        target, sig = autoscale_step(
            scaler, _stats(num_shards=2, depth=90, capacity=100)
        )
        assert sig.occupancy == 0.9
        assert target == 3
        state = scaler.state()
        assert state["last_occupancy"] == 0.9


class TestParityWithJax:
    @pytest.mark.parametrize("seed", range(3))
    def test_same_signals_same_decisions(self, seed):
        rng = np.random.default_rng(seed)
        cfg = {"min_shards": 1, "max_shards": 6, "hysteresis": int(rng.integers(1, 4)), "step": int(rng.integers(1, 3))}
        scalers = {"torch": Autoscaler(AutoscalerConfig(**cfg)), "jax": jserve.Autoscaler(jserve.AutoscalerConfig(**cfg))}
        steps = {"torch": autoscale_step, "jax": jserve.autoscale_step}
        shards, backoff = 2, 0.0
        for _ in range(200):
            backoff += float(rng.choice([0.0, 0.0, 0.25, 0.75]))
            stats = _stats(num_shards=shards, depth=int(rng.integers(0, 101)), resizing=bool(rng.integers(0, 8) == 0))
            counters = {("serve.forwarder_backoff_secs", (("shard", "0"),)): backoff}
            out = {pkg: steps[pkg](scalers[pkg], stats, counters) for pkg in scalers}
            assert out["torch"][0] == out["jax"][0]
            assert out["torch"][1].__dict__ == out["jax"][1].__dict__
            assert scalers["torch"].state() == scalers["jax"].state()
            shards = out["torch"][0]
