"""The port's checkpoint manager: atomicity, integrity, elasticity, chaos.

Each case mirrors one of ``tests/bases/test_checkpoint_manager.py`` on
``metrics_tpu_torch`` (CPU states): every storage fault the ``ChaosStore``
injects (torn write, bit flip, missing shard, stale manifest) lands on its
``on_restore_error`` outcome, and save -> kill -> restore -> resume
reproduces the uninterrupted run bit for bit for every state kind (scalar
tensor, list, buffer, sketch, window ring).  The JAX package's observability
counter case (``TestCounters::test_ckpt_counters_flow_to_summary``) has no
counterpart: the port has no counters yet.  Its two shrink drills, marked
slow there, run here at a smaller size (their sketches merge in one fold).
"""

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import metrics_tpu_torch as mt
from metrics_tpu_torch.checkpoint import (
    ChaosStore,
    CheckpointIntegrityError,
    CheckpointManager,
    CheckpointRestoreError,
    LocalStore,
    encode_metric,
)
from metrics_tpu_torch.checkpoint.codec import arrays_to_merge_state, decode_metric
from metrics_tpu_torch.utils.exceptions import CheckpointError

CPU = {"device": "cpu"}


def _mixed_collection():
    """One metric per state kind: tensor, list/cat, buffer, sketch."""
    return mt.MetricCollection(
        {
            "mean": mt.MeanMetric(**CPU),  # tensor states
            "cat": mt.CatMetric(**CPU),  # list state
            "auroc": mt.AUROC(**CPU),  # buffer states + runtime mode attr
            "q": mt.StreamingQuantile(q=0.5, **CPU),  # sketch state
        },
        **CPU,
    )


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _feed(col, rng, n=4):
    for _ in range(n):
        x = _t(rng.normal(size=16).astype(np.float32))
        col["mean"].update(x)
        col["cat"].update(x)
        col["auroc"].update(_t(rng.uniform(size=16).astype(np.float32)), _t(rng.integers(0, 2, 16)))
        col["q"].update(x)


def _computes(col):
    return {k: np.asarray(v) for k, v in col.compute().items()}


def _mgr(tmp_path, **kw):
    kw.setdefault("rank", 0)
    kw.setdefault("world_size", 1)
    return CheckpointManager(str(tmp_path), **kw)


def _save_world(tmp_path, cols, step=0, **kw):
    """One collective save with len(cols) emulated ranks (threads: the
    non-zero ranks poll until rank 0 commits the manifest)."""
    world = len(cols)
    mgrs = [CheckpointManager(str(tmp_path), rank=r, world_size=world, **kw) for r in range(world)]
    with ThreadPoolExecutor(world) as ex:
        steps = list(ex.map(lambda a: a[0].save(a[1], step=step), zip(mgrs, cols)))
    assert steps == [step] * world
    return mgrs


def _sum_metric(*values):
    m = mt.SumMetric(**CPU)
    for v in values:
        m.update(torch.tensor(v))
    return m


class TestSaveRestoreRoundTrip:
    def test_every_state_kind_bit_exact_after_kill_and_restore(self, tmp_path):
        rng = np.random.default_rng(0)
        col = _mixed_collection()
        _feed(col, rng)
        before = _computes(col)
        _mgr(tmp_path).save(col)

        col2 = _mixed_collection()  # a new process builds fresh objects
        res = _mgr(tmp_path).restore(col2)
        assert sorted(res.restored_metrics) == ["col/auroc", "col/cat", "col/mean", "col/q"]
        after = _computes(col2)
        for key in before:
            np.testing.assert_array_equal(before[key], after[key], err_msg=key)

    def test_resume_after_restore_matches_uninterrupted_run(self, tmp_path):
        rng = np.random.default_rng(1)
        col = _mixed_collection()
        _feed(col, rng, n=3)
        _mgr(tmp_path).save(col)
        col2 = _mixed_collection()
        _mgr(tmp_path).restore(col2)

        _feed(col, np.random.default_rng(7), n=3)
        _feed(col2, np.random.default_rng(7), n=3)
        a, b = _computes(col), _computes(col2)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)

    def test_update_counts_and_sync_rounds_recorded(self, tmp_path):
        m = mt.MeanMetric(**CPU)
        m.update(torch.tensor([1.0, 2.0]))
        m.update(torch.tensor([3.0]))
        step = _mgr(tmp_path).save(m)
        manifest = json.loads((tmp_path / f"step_{step:08d}" / "MANIFEST.json").read_text())
        info = manifest["shards"]["0"]["metrics"]["metric"]
        assert info["update_count"] == 2
        assert set(info["digests"]) >= {"mean_value", "weight", "__meta__"}

    def test_tracker_restore_rebuilds_steps(self, tmp_path):
        tr = mt.MetricTracker(mt.MeanMetric(**CPU), maximize=True)
        for s in range(3):
            tr.increment()
            tr.update(torch.tensor([float(s), float(s + 1)]))
        before = np.asarray(tr.compute_all())
        _mgr(tmp_path).save(tr)

        tr2 = mt.MetricTracker(mt.MeanMetric(**CPU), maximize=True)
        _mgr(tmp_path).restore(tr2)
        assert tr2.n_steps == 3
        np.testing.assert_array_equal(before, np.asarray(tr2.compute_all()))

    def test_windowed_metric_ring_buffer_round_trip(self, tmp_path):
        w = mt.WindowedMetric(mt.MeanMetric(**CPU), window_size=3, **CPU)
        for i in range(7):
            w.update(torch.tensor(float(i)))
            w.advance()
        w.update(torch.tensor(100.0))
        before = np.asarray(w.compute())
        _mgr(tmp_path).save(w)

        w2 = mt.WindowedMetric(mt.MeanMetric(**CPU), window_size=3, **CPU)
        _mgr(tmp_path).restore(w2)
        np.testing.assert_array_equal(before, np.asarray(w2.compute()))
        for m_ in (w, w2):  # the window keeps sliding identically after restore
            m_.advance()
            m_.update(torch.tensor(-3.0))
        np.testing.assert_array_equal(np.asarray(w.compute()), np.asarray(w2.compute()))

    def test_runtime_mode_attr_survives_restore(self, tmp_path):
        m = mt.Accuracy(num_classes=3, validate_args=False, **CPU)
        rng = np.random.default_rng(2)
        m.update(_t(rng.integers(0, 3, 32)), _t(rng.integers(0, 3, 32)))
        before = float(m.compute())
        _mgr(tmp_path).save(m)

        m2 = mt.Accuracy(num_classes=3, validate_args=False, **CPU)
        _mgr(tmp_path).restore(m2)
        assert m2.mode is not None
        assert float(m2.compute()) == before

    def test_compute_groups_reshared_after_restore(self, tmp_path):
        def make():
            return mt.MetricCollection(
                {
                    "p": mt.Precision(num_classes=3, average="macro", **CPU),
                    "r": mt.Recall(num_classes=3, average="macro", **CPU),
                },
                compute_groups=True,
                **CPU,
            )

        col = make()
        rng = np.random.default_rng(3)
        for _ in range(3):
            col.update(_t(rng.integers(0, 3, 16)), _t(rng.integers(0, 3, 16)))
        before = _computes(col)
        _mgr(tmp_path).save(col)

        col2 = make()
        col2.update(_t(rng.integers(0, 3, 8)), _t(rng.integers(0, 3, 8)))  # group detection first
        _mgr(tmp_path).restore(col2)
        after = _computes(col2)
        for key in before:
            np.testing.assert_array_equal(before[key], after[key], err_msg=key)
        # the members alias one state again: an update through the collection moves both
        assert col2["p"].tp is col2["r"].tp
        col2.update(_t(rng.integers(0, 3, 16)), _t(rng.integers(0, 3, 16)))
        assert col2["p"].tp is col2["r"].tp
        col2.compute()

    def test_delta_cache_rearmed_not_restored(self, tmp_path):
        m = mt.CatMetric(**CPU)
        m.update(torch.tensor([1.0, 2.0]))
        m._delta_cache.round = 5  # pretend a delta prefix was negotiated
        _mgr(tmp_path).save(m)
        m2 = mt.CatMetric(**CPU)
        _mgr(tmp_path).restore(m2)
        assert m2._delta_cache.round == 0
        assert m2._delta_cache.prefixes == {}


class TestRetention:
    def test_keep_last_k_prunes_older_steps(self, tmp_path):
        m = mt.SumMetric(**CPU)
        mgr = _mgr(tmp_path, keep_last=2)
        for s in range(5):
            m.update(torch.tensor(1.0))
            mgr.save(m, step=s)
        dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
        assert dirs == ["step_00000003", "step_00000004"]
        assert mgr.latest_step() == 4

    def test_gc_sweeps_crash_trash(self, tmp_path):
        (tmp_path / ".trash.step_00000000.deadbeef").mkdir()
        (tmp_path / ".tmp.deadbeef").write_bytes(b"partial")
        _mgr(tmp_path, keep_last=1).save(_sum_metric(1.0))
        left = set(os.listdir(tmp_path))
        assert not any(e.startswith((".trash.", ".tmp.")) for e in left)

    def test_restore_specific_step(self, tmp_path):
        m = mt.SumMetric(**CPU)
        mgr = _mgr(tmp_path, keep_last=None)
        for s in range(3):
            m.update(torch.tensor(1.0))
            mgr.save(m, step=s)
        m2 = mt.SumMetric(**CPU)
        res = _mgr(tmp_path).restore(m2, step=1)
        assert res.step == 1
        assert float(m2.compute()) == 2.0


class TestChaosRestore:
    """Each injected storage fault hits its intended policy outcome."""

    def _saved(self, tmp_path, rng_seed=0):
        col = _mixed_collection()
        _feed(col, np.random.default_rng(rng_seed))
        _mgr(tmp_path).save(col)
        return _computes(col)

    def test_torn_manifest_write_falls_back_to_older_step(self, tmp_path):
        m = _sum_metric(1.0)
        _mgr(tmp_path).save(m, step=0)  # a good checkpoint
        chaos = ChaosStore(LocalStore(str(tmp_path)), faults=[("torn_write", "MANIFEST")])
        m.update(torch.tensor(1.0))
        mgr = CheckpointManager(store=chaos, rank=0, world_size=1)
        with pytest.raises(CheckpointError):
            mgr.save(m, step=1)  # the commit write is torn: the save must not report success
        m2 = mt.SumMetric(**CPU)
        res = _mgr(tmp_path).restore(m2)
        assert res.step == 0
        assert 1 in res.stale_steps  # the torn manifest was seen and rejected
        assert float(m2.compute()) == 1.0

    def test_torn_shard_write_skips_step(self, tmp_path):
        m = _sum_metric(2.0)
        _mgr(tmp_path).save(m, step=0)
        # step 1's shard is torn but its manifest committed: restore must reject the payload
        chaos = ChaosStore(LocalStore(str(tmp_path)), faults=[("torn_write", "shard_00000.bin")])
        m.update(torch.tensor(3.0))
        CheckpointManager(store=chaos, rank=0, world_size=1).save(m, step=1)
        with pytest.raises((CheckpointIntegrityError, CheckpointRestoreError)):
            _mgr(tmp_path, on_restore_error="raise").restore(mt.SumMetric(**CPU))
        m3 = mt.SumMetric(**CPU)
        res = _mgr(tmp_path, on_restore_error="reset_metric").restore(m3)
        assert res.step == 1
        assert res.missing_shards == [0] or res.reset_metrics
        assert float(m3.compute()) == 0.0  # degraded: the metric restarts clean

    @pytest.mark.parametrize("policy", ["raise", "skip_state", "reset_metric"])
    def test_single_bit_flip_under_each_policy(self, tmp_path, policy):
        before = self._saved(tmp_path)
        chaos = ChaosStore(LocalStore(str(tmp_path)), faults=[("bit_flip", "shard_00000.bin")])
        col = _mixed_collection()
        mgr = CheckpointManager(store=chaos, rank=0, world_size=1, on_restore_error=policy)
        if policy == "raise":
            with pytest.raises(CheckpointIntegrityError) as exc_info:
                mgr.restore(col)
            assert exc_info.value.shard == 0
            return
        res = mgr.restore(col)
        damaged = {m_key for m_key, _ in res.skipped_states} | set(res.reset_metrics)
        assert damaged  # something degraded...
        if policy == "skip_state":
            assert res.skipped_states
        else:
            assert not res.skipped_states and res.reset_metrics
            for key in res.reset_metrics:
                assert col[key.split("/", 1)[1]].update_count == 0
        after = _computes(col)
        for k in before:  # ...and every other metric is bit-exact
            if f"col/{k}" not in damaged:
                np.testing.assert_array_equal(before[k], after[k], err_msg=k)

    def test_missing_rank_shard(self, tmp_path):
        self._saved(tmp_path)
        chaos = ChaosStore(LocalStore(str(tmp_path)), faults=[("missing", "shard_00000.bin")])
        with pytest.raises(CheckpointRestoreError):
            CheckpointManager(store=chaos, rank=0, world_size=1).restore(_mixed_collection())

        chaos2 = ChaosStore(LocalStore(str(tmp_path)), faults=[("missing", "shard_00000.bin")])
        res = CheckpointManager(store=chaos2, rank=0, world_size=1, on_restore_error="skip_state").restore(
            _mixed_collection()
        )
        assert res.missing_shards == [0]
        assert sorted(res.reset_metrics) == ["col/auroc", "col/cat", "col/mean", "col/q"]

    def test_stale_manifest_detected_and_skipped(self, tmp_path):
        m = _sum_metric(5.0)
        _mgr(tmp_path).save(m, step=0)
        m.update(torch.tensor(7.0))
        _mgr(tmp_path).save(m, step=1)
        # step 1's manifest replaced by step 0's: the manifest names its step, so the dir is stale
        stale = (tmp_path / "step_00000000" / "MANIFEST.json").read_bytes()
        LocalStore(str(tmp_path)).write_atomic("step_00000001/MANIFEST.json", stale)
        m2 = mt.SumMetric(**CPU)
        res = _mgr(tmp_path).restore(m2)
        assert res.step == 0
        assert 1 in res.stale_steps
        assert float(m2.compute()) == 5.0

    def test_uncommitted_step_invisible(self, tmp_path):
        # a crash after the shard write, before the manifest: the step must not restore
        m = _sum_metric(1.0)
        _mgr(tmp_path).save(m, step=0)
        chaos = ChaosStore(LocalStore(str(tmp_path)), faults=[("drop_write", "MANIFEST")])
        m.update(torch.tensor(1.0))
        mgr = CheckpointManager(store=chaos, rank=0, world_size=1, barrier_timeout=1.0)
        with pytest.raises(CheckpointError):
            mgr.save(m, step=1)
        assert (tmp_path / "step_00000001" / "shard_00000.bin").exists()
        res = _mgr(tmp_path).restore(mt.SumMetric(**CPU))
        assert res.step == 0

    def test_no_checkpoint_raises_restore_error(self, tmp_path):
        with pytest.raises(CheckpointRestoreError):
            _mgr(tmp_path).restore(mt.SumMetric(**CPU))


def _merge_tree_from(metric):
    """A merge_state tree from a live metric, through the codec."""
    enc = encode_metric(metric)
    dec = decode_metric(enc.blob, enc.digests)
    assert not dec.failed
    return arrays_to_merge_state(metric, dec.arrays)


class TestElasticRestore:
    def _world_data(self, world, n=4, seed=0):
        rng = np.random.default_rng(seed)
        cols, all_rows = [], []
        for _ in range(world):
            col = _mixed_collection()
            for _ in range(n):
                x = rng.normal(size=16).astype(np.float32)
                probs, labels = rng.uniform(size=16).astype(np.float32), rng.integers(0, 2, 16)
                col["mean"].update(_t(x))
                col["cat"].update(_t(x))
                col["auroc"].update(_t(probs), _t(labels))
                col["q"].update(_t(x))
                all_rows.append((x, probs, labels))
            cols.append(col)
        ref = _mixed_collection()
        for x, probs, labels in all_rows:
            ref["mean"].update(_t(x))
            ref["cat"].update(_t(x))
            ref["auroc"].update(_t(probs), _t(labels))
            ref["q"].update(_t(x))
        return cols, _computes(ref)

    def test_shrink_two_to_one_folds_extra_shard(self, tmp_path):
        cols, ref = self._world_data(world=2)
        _save_world(tmp_path, cols)

        col = _mixed_collection()
        res = CheckpointManager(str(tmp_path), rank=0, world_size=1).restore(col)
        assert res.world_size == 2
        assert res.folded_shards == [1]
        got = _computes(col)
        # mean/cat/auroc merge exactly (disjoint rows, order kept); the sketch
        # merge is the kll_merge the sync path uses
        for key in ref:
            np.testing.assert_allclose(ref[key], got[key], atol=1e-6, err_msg=key)

    def test_grow_one_to_two_leaves_new_rank_reset(self, tmp_path):
        cols, _ref = self._world_data(world=1)
        _save_world(tmp_path, cols)
        before = _computes(cols[0])

        col0 = _mixed_collection()  # rank 0 of the grown world gets the old shard bit for bit
        res0 = CheckpointManager(str(tmp_path), rank=0, world_size=2).restore(col0)
        assert res0.folded_shards == []
        after0 = _computes(col0)
        for key in before:
            np.testing.assert_array_equal(before[key], after0[key], err_msg=key)

        col1 = _mixed_collection()  # rank 1 has no shard to own: it starts reset
        res1 = CheckpointManager(str(tmp_path), rank=1, world_size=2).restore(col1)
        assert res1.restored_metrics == []
        assert sorted(res1.reset_metrics) == ["col/auroc", "col/cat", "col/mean", "col/q"]
        assert col1["mean"]._update_count == 0

    def test_shrink_three_to_two_distributes_folds(self, tmp_path):
        cols, ref = self._world_data(world=3, n=2, seed=4)
        _save_world(tmp_path, cols)

        restored = []
        for r in range(2):
            col = _mixed_collection()
            res = CheckpointManager(str(tmp_path), rank=r, world_size=2).restore(col)
            restored.append((col, res))
        assert restored[0][1].folded_shards == [2]  # 0 <- {0, 2}
        assert restored[1][1].folded_shards == []  # 1 <- {1}
        merged = _mixed_collection()
        merged["auroc"].mode = restored[0][0]["auroc"].mode
        for col, _res in restored:
            for name in ("mean", "cat", "auroc", "q"):
                other = col[name]
                merged[name].merge_state(_merge_tree_from(other), other_count=int(other._update_count))
        got = _computes(merged)
        for key in ref:
            a, b = ref[key], got[key]
            if key == "cat":  # the concatenation order differs across fold plans
                a, b = np.sort(a), np.sort(b)
            np.testing.assert_allclose(a, b, atol=1e-6, err_msg=key)


class TestStoreAtomicity:
    def test_write_atomic_replaces_not_appends(self, tmp_path):
        store = LocalStore(str(tmp_path))
        store.write_atomic("a/b.bin", b"one")
        store.write_atomic("a/b.bin", b"twotwo")
        assert store.read("a/b.bin") == b"twotwo"
        assert store.listdir("a") == ["b.bin"]  # no tmp debris
        assert store.bytes_written == 9 and store.fsyncs >= 2

    def test_remove_tree_is_rename_first(self, tmp_path):
        store = LocalStore(str(tmp_path))
        store.write_atomic("gone/x.bin", b"x")
        store.remove_tree("gone")
        assert not store.exists("gone/x.bin")
        assert store.sweep_trash() == 0  # rmtree already finished

    def test_chaos_stale_serves_pre_overwrite_content(self, tmp_path):
        inner = LocalStore(str(tmp_path))
        inner.write_atomic("m.json", b"v1")
        chaos = ChaosStore(inner, faults=[("stale", "m.json")])
        chaos.write_atomic("m.json", b"v2")  # lands on disk...
        assert chaos.read("m.json") == b"v1"  # ...but the reader sees v1
        assert ("stale", "m.json") in chaos.injected

    def test_chaos_store_records_injections(self, tmp_path):
        chaos = ChaosStore(LocalStore(str(tmp_path)), faults=[("bit_flip", "x.bin")])
        chaos.write_atomic("x.bin", b"hello world")
        assert chaos.read("x.bin") != b"hello world"
        assert chaos.injected == [("bit_flip", "x.bin")]
        assert chaos.read("x.bin") == b"hello world"  # a fault fires once

    def test_chaos_store_validates_fault_kinds(self, tmp_path):
        with pytest.raises(ValueError, match="unknown chaos fault"):
            ChaosStore(LocalStore(str(tmp_path)), faults=[("melt", "x")])

    def test_manager_validates_policy(self, tmp_path):
        with pytest.raises(ValueError, match="on_restore_error"):
            CheckpointManager(str(tmp_path), on_restore_error="explode")


class TestStalenessSeam:
    """The durability loop's trigger surface: ``save_now`` / ``request_save``
    and the ``max_staleness`` cadence."""

    def _target(self):
        m = mt.MeanMetric(**CPU)
        m.update(1.0)
        return m

    def test_max_staleness_validated(self, tmp_path):
        for bad in (0, -1.0):
            with pytest.raises(ValueError, match="max_staleness"):
                _mgr(tmp_path, max_staleness=bad)

    def test_no_budget_never_due(self, tmp_path):
        mgr = _mgr(tmp_path)
        assert mgr.max_staleness is None
        assert not mgr.save_due()
        assert mgr.seconds_until_due() is None
        assert mgr.maybe_save(self._target()) is None
        assert mgr.latest_step() is None

    def test_staleness_budget_turns_due_and_save_resets_it(self, tmp_path):
        mgr = _mgr(tmp_path, max_staleness=0.05)
        remaining = mgr.seconds_until_due()
        assert remaining is not None and 0.0 <= remaining <= 0.05
        time.sleep(0.06)
        assert mgr.staleness() >= 0.05
        assert mgr.save_due()
        assert mgr.maybe_save(self._target()) == 0
        assert not mgr.save_due()  # the committed save restarted the budget
        assert mgr.staleness() < 0.05
        assert mgr.maybe_save(self._target()) is None

    def test_request_save_arms_immediately(self, tmp_path):
        mgr = _mgr(tmp_path, max_staleness=3600.0)
        assert not mgr.save_due()
        mgr.request_save()
        assert mgr.save_due()
        assert mgr.seconds_until_due() == 0.0
        assert mgr.save_now(self._target()) == 0
        assert not mgr.save_due()  # save_now cleared the armed request

    def test_restore_counts_as_durable(self, tmp_path):
        mgr = _mgr(tmp_path, max_staleness=0.05)
        mgr.save(self._target())
        time.sleep(0.06)
        assert mgr.save_due()
        mgr.restore(mt.MeanMetric(**CPU))
        assert not mgr.save_due()  # the restored state is the durable state

    def test_failed_save_keeps_the_trigger_armed(self, tmp_path):
        store = ChaosStore(LocalStore(str(tmp_path)), faults=[("torn_write", "MANIFEST")])
        mgr = CheckpointManager(store=store, rank=0, world_size=1, max_staleness=3600.0)
        mgr.request_save()
        with pytest.raises(CheckpointError):
            mgr.save_now(self._target())
        assert mgr.save_due()  # the fault ate the commit; the request survives for the retry
        assert mgr.save_now(self._target()) == 0
        assert not mgr.save_due()

    def test_save_now_extra_rides_the_commit(self, tmp_path):
        mgr = _mgr(tmp_path)
        mgr.save_now(self._target(), extra={"wal": {"applied_seq": 41}})
        res = _mgr(tmp_path).restore(mt.MeanMetric(**CPU))
        assert res.extra == {"wal": {"applied_seq": 41}}


def test_default_identity_without_a_process_group(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert (mgr.rank, mgr.world_size) == (0, 1)
    assert mgr._kv_client() is None
