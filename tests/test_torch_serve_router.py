"""The port's ``ShardRouter`` / ``HashRing`` (``metrics_tpu_torch.serve.router``): span math, clamping,
vectorized partition, resize plans.

Mirrors ``tests/serve/test_router.py`` case for case, then holds the port
against the JAX package: the same keys land on the same shards at every
fleet width, bulk routes and owners are equal, and ``migration_plan``
gives the same moves for the same pair of widths.
"""

import numpy as np
import pytest

from metrics_tpu import serve as jserve
from metrics_tpu_torch.obs import counter_value
from metrics_tpu_torch.serve import HashRing, ShardRouter, migration_plan
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError


class TestHashRing:
    def test_lookup_is_deterministic_across_instances(self):
        a = HashRing(range(4), vnodes=32)
        b = HashRing(range(4), vnodes=32)
        for key in ("mse", "accuracy", "f1", "a/b/c", ""):
            assert a.lookup(key) == b.lookup(key)

    def test_lookup_spreads_keys(self):
        ring = HashRing(range(4), vnodes=64)
        owners = {ring.lookup(f"job-{i}") for i in range(200)}
        assert owners == {0, 1, 2, 3}

    def test_resize_moves_a_minority_of_keys(self):
        small = HashRing(range(4), vnodes=64)
        grown = HashRing(range(5), vnodes=64)
        keys = [f"job-{i}" for i in range(500)]
        moved = sum(small.lookup(k) != grown.lookup(k) for k in keys)
        # consistent hashing: ~1/5 of keys move to the new shard; a full
        # reshuffle would move ~4/5
        assert moved < len(keys) // 2

    def test_validation(self):
        with pytest.raises(MetricsTPUUserError):
            HashRing([])
        with pytest.raises(MetricsTPUUserError):
            HashRing([0], vnodes=0)


class TestSpans:
    def test_spans_cover_contiguously(self):
        router = ShardRouter(3, {"tenants": 10})
        spans = [router.span("tenants", s) for s in range(3)]
        assert spans[0][0] == 0
        assert spans[-1][1] == 10
        for (_, hi), (lo, _) in zip(spans, spans[1:]):
            assert hi == lo
        assert sum(router.span_width("tenants", s) for s in range(3)) == 10
        assert router.num_streams("tenants") == 10

    def test_every_stream_routes_to_its_span(self):
        router = ShardRouter(3, {"tenants": 10})
        for sid in range(10):
            shard = router.shard_for("tenants", sid)
            lo, hi = router.span("tenants", shard)
            assert lo <= sid < hi
            s2, local = router.local_id("tenants", sid)
            assert s2 == shard and local == sid - lo
            assert router.global_id("tenants", shard, local) == sid

    def test_out_of_range_ids_clamp_but_keep_local_offset(self):
        router = ShardRouter(2, {"tenants": 8})
        shard, local = router.local_id("tenants", -3)
        assert shard == 0 and local == -3
        shard, local = router.local_id("tenants", 11)
        lo, _hi = router.span("tenants", 1)
        assert shard == 1 and local == 11 - lo
        # the local offset lands outside the span width, so the worker's
        # device drop lane counts it exactly like an unsharded worker would
        assert local >= router.span_width("tenants", 1)

    def test_plain_job_placement(self):
        router = ShardRouter(4, {"mse": None, "tenants": 16})
        owner = router.owner("mse")
        assert 0 <= owner < 4
        assert router.shard_for("mse") == owner
        assert not router.is_multistream("mse")
        assert router.is_multistream("tenants")
        # same ring, same placement in a rebuilt router
        assert ShardRouter(4, {"mse": None}).owner("mse") == owner

    def test_error_surfaces(self):
        router = ShardRouter(2, {"mse": None, "tenants": 8})
        with pytest.raises(MetricsTPUUserError):
            router.shard_for("nope")
        with pytest.raises(MetricsTPUUserError):
            router.shard_for("tenants")  # multistream needs a stream_id
        with pytest.raises(MetricsTPUUserError):
            router.owner("tenants")
        with pytest.raises(MetricsTPUUserError):
            router.span("mse", 0)
        with pytest.raises(MetricsTPUUserError):
            router.num_streams("mse")
        with pytest.raises(MetricsTPUUserError):
            router.partition_ids("mse", np.arange(3))
        with pytest.raises(MetricsTPUUserError):
            ShardRouter(0, {})
        with pytest.raises(MetricsTPUUserError):
            ShardRouter(4, {"tenants": 2})  # fewer streams than shards


class TestPartitionIds:
    def test_partition_matches_scalar_routing(self):
        router = ShardRouter(3, {"tenants": 11})
        rng = np.random.default_rng(0)
        ids = rng.integers(-2, 13, size=64).astype(np.int64)  # includes OOB
        parts = router.partition_ids("tenants", ids)
        seen = np.zeros(len(ids), bool)
        for shard, (positions, locals_) in parts.items():
            assert not seen[positions].any()
            seen[positions] = True
            lo = router.span("tenants", shard)[0]
            for pos, local in zip(positions, locals_):
                exp_shard, exp_local = router.local_id("tenants", int(ids[pos]))
                assert exp_shard == shard
                assert int(local) == exp_local == int(ids[pos]) - lo

        assert seen.all()  # every row lands on exactly one shard

    def test_partition_preserves_arrival_order_within_shard(self):
        router = ShardRouter(2, {"tenants": 8})
        ids = np.array([7, 0, 5, 1, 6, 2], np.int64)
        parts = router.partition_ids("tenants", ids)
        for positions, _locals in parts.values():
            assert list(positions) == sorted(positions)

    def test_partition_counts_routes(self):
        router = ShardRouter(2, {"tenants": 8})
        before = sum(
            counter_value("serve.shard_routes", shard=str(s)) for s in range(2)
        )
        router.partition_ids("tenants", np.arange(8))
        after = sum(
            counter_value("serve.shard_routes", shard=str(s)) for s in range(2)
        )
        assert after == before + 8

    def test_empty_shards_are_omitted(self):
        router = ShardRouter(4, {"tenants": 16})
        lo, hi = router.span("tenants", 2)
        parts = router.partition_ids("tenants", np.arange(lo, hi))
        assert list(parts) == [2]


class TestOwnerOfIds:
    def test_matches_scalar_routing_including_oob(self):
        router = ShardRouter(3, {"tenants": 11})
        ids = np.array([-2, 0, 3, 4, 7, 10, 12], np.int64)
        owners = router.owner_of_ids("tenants", ids)
        for sid, owner in zip(ids, owners):
            assert int(owner) == router.local_id("tenants", int(sid))[0]

    def test_does_not_count_routes(self):
        # the forwarder calls this on every drain pass; it must not inflate
        # serve.shard_routes the way partition_ids (one call per batch) does
        router = ShardRouter(2, {"tenants": 8})
        before = sum(
            counter_value("serve.shard_routes", shard=str(s)) for s in range(2)
        )
        router.owner_of_ids("tenants", np.arange(8))
        after = sum(
            counter_value("serve.shard_routes", shard=str(s)) for s in range(2)
        )
        assert after == before


class TestMinimalMovement:
    """Quantitative consistent-hashing guarantees of the blake2b ring."""

    def test_grow_moves_keys_only_to_the_new_shard(self):
        # the strong form of minimal movement: adding shard N may steal
        # keys, but every stolen key lands ON shard N — no lateral churn
        old = HashRing(range(6), vnodes=64)
        new = HashRing(range(7), vnodes=64)
        for i in range(400):
            key = f"job-{i}"
            if old.lookup(key) != new.lookup(key):
                assert new.lookup(key) == 6

    def test_shrink_moves_only_the_departing_shards_keys(self):
        old = HashRing(range(7), vnodes=64)
        new = HashRing(range(6), vnodes=64)
        for i in range(400):
            key = f"job-{i}"
            if old.lookup(key) == 6:
                assert new.lookup(key) != 6
            else:
                assert new.lookup(key) == old.lookup(key)

    def test_grow_steals_roughly_its_fair_share(self):
        # expectation is 1/(N+1) of keys; allow a generous 3x statistical
        # margin so vnode variance cannot flake the suite
        n, keys = 6, [f"job-{i}" for i in range(1200)]
        old = HashRing(range(n), vnodes=64)
        new = HashRing(range(n + 1), vnodes=64)
        moved = sum(old.lookup(k) != new.lookup(k) for k in keys)
        assert 0 < moved < 3 * len(keys) // (n + 1)


class TestResizedAndMigrationPlan:
    JOBS = {"mse": None, "acc": None, "f1": None, "tenants": 48, "loss": 96}

    def test_resized_bumps_epoch_and_keeps_vnodes(self):
        router = ShardRouter(3, self.JOBS, vnodes=32)
        grown = router.resized(5)
        assert router.epoch == 0 and grown.epoch == 1
        assert grown.num_shards == 5
        assert grown.resized(3).epoch == 2
        # same ring geometry: a plain job that did not move hashes alike
        rebuilt = ShardRouter(5, self.JOBS, vnodes=32)
        for job in ("mse", "acc", "f1"):
            assert grown.owner(job) == rebuilt.owner(job)

    def test_plan_moves_exactly_the_changed_rows(self):
        old = ShardRouter(3, self.JOBS)
        new = old.resized(5)
        plan = migration_plan(old, new)
        assert plan.old_shards == 3 and plan.new_shards == 5
        for job in ("tenants", "loss"):
            total = old.num_streams(job)
            moved = np.zeros(total, np.int32)
            for move in plan.moves:
                if move.job != job:
                    continue
                assert not move.plain and move.donor != move.recipient
                o_lo, o_hi = old.span(job, move.donor)
                n_lo, n_hi = new.span(job, move.recipient)
                assert o_lo <= move.lo < move.hi <= o_hi
                assert n_lo <= move.lo < move.hi <= n_hi
                moved[move.lo : move.hi] += 1
            for sid in range(total):
                changed = (
                    old.local_id(job, sid)[0] != new.local_id(job, sid)[0]
                )
                assert moved[sid] == int(changed)  # once if moved, else never
        assert plan.rows() == int(
            sum(
                old.local_id(j, s)[0] != new.local_id(j, s)[0]
                for j in ("tenants", "loss")
                for s in range(old.num_streams(j))
            )
        )

    def test_plan_plain_moves_track_ring_ownership(self):
        old = ShardRouter(6, self.JOBS)
        new = old.resized(7)
        plan = migration_plan(old, new)
        plain = {m.job: m for m in plan.moves if m.plain}
        for job in ("mse", "acc", "f1"):
            if old.owner(job) != new.owner(job):
                move = plain[job]
                assert move.donor == old.owner(job)
                assert move.recipient == new.owner(job)
            else:
                assert job not in plain

    def test_randomized_resize_sequence_invariants(self):
        rng = np.random.default_rng(42)
        router = ShardRouter(2, self.JOBS)
        for step in range(12):
            n = int(rng.integers(1, 9))
            if n == router.num_shards:
                n += 1
            new = router.resized(n)
            assert new.epoch == router.epoch + 1
            plan = migration_plan(router, new)
            for job in ("tenants", "loss"):
                # new spans tile [0, S) contiguously after every resize
                spans = [new.span(job, s) for s in range(n)]
                assert spans[0][0] == 0
                assert spans[-1][1] == router.num_streams(job)
                for (_, hi), (lo, _) in zip(spans, spans[1:]):
                    assert hi == lo
                # every changed row moves exactly once, donor -> recipient
                for sid in range(router.num_streams(job)):
                    old_owner = router.local_id(job, sid)[0]
                    new_owner = new.local_id(job, sid)[0]
                    hits = [
                        m
                        for m in plan.moves
                        if m.job == job and not m.plain and m.lo <= sid < m.hi
                    ]
                    if old_owner == new_owner:
                        assert hits == []
                    else:
                        assert len(hits) == 1
                        assert hits[0].donor == old_owner
                        assert hits[0].recipient == new_owner
            router = new

    def test_plan_rejects_mismatched_routers(self):
        old = ShardRouter(2, {"tenants": 8})
        with pytest.raises(MetricsTPUUserError):
            migration_plan(old, ShardRouter(3, {"other": 8}))
        with pytest.raises(MetricsTPUUserError):
            migration_plan(old, ShardRouter(3, {"tenants": 12}))
        with pytest.raises(MetricsTPUUserError):
            migration_plan(old, ShardRouter(3, {"tenants": None}))


class TestParityWithJax:
    JOBS = {"mse": None, "acc": None, "f1": None, "p99": None, "tenants": 48, "loss": 96, "users": 1000}

    @pytest.mark.parametrize("vnodes", [1, 16, 64])
    def test_ring_placements_equal(self, vnodes):
        keys = [f"job-{i}" for i in range(300)] + ["", "mse", "jöb/ünï:1"]
        for n in range(1, 9):
            port, ref = HashRing(range(n), vnodes=vnodes), jserve.HashRing(range(n), vnodes=vnodes)
            assert [port.lookup(k) for k in keys] == [ref.lookup(k) for k in keys]

    def test_routes_and_owners_equal(self):
        rng = np.random.default_rng(3)
        ids = rng.integers(-5, 1010, 500).astype(np.int64)
        for n in (1, 2, 3, 5, 8):
            port, ref = ShardRouter(n, self.JOBS), jserve.ShardRouter(n, self.JOBS)
            assert port.jobs() == ref.jobs()
            for job in ("mse", "acc", "f1", "p99"):
                assert port.owner(job) == ref.owner(job)
            for job in ("tenants", "loss", "users"):
                assert [port.span(job, s) for s in range(n)] == [ref.span(job, s) for s in range(n)]
                assert port.owner_of_ids(job, ids).tolist() == ref.owner_of_ids(job, ids).tolist()
                got, want = port.partition_ids(job, ids), ref.partition_ids(job, ids)
                assert got.keys() == want.keys()
                for shard in want:
                    assert [a.tolist() for a in got[shard]] == [a.tolist() for a in want[shard]]
                    assert got[shard][1].dtype == want[shard][1].dtype
                for sid in (-3, 0, 47, 999, 1004):
                    assert port.local_id(job, sid) == ref.local_id(job, sid)

    def test_migration_plans_equal(self):
        for old_n in range(1, 7):
            for new_n in range(1, 7):
                if old_n == new_n:
                    continue
                port = migration_plan(ShardRouter(old_n, self.JOBS), ShardRouter(new_n, self.JOBS))
                ref = jserve.migration_plan(jserve.ShardRouter(old_n, self.JOBS), jserve.ShardRouter(new_n, self.JOBS))
                assert [m.__dict__ for m in port.moves] == [m.__dict__ for m in ref.moves]
                assert (port.old_shards, port.new_shards, port.rows(), port.jobs()) == (
                    ref.old_shards, ref.new_shards, ref.rows(), ref.jobs()
                )
