"""Asynchronous overlapped sync of the port against the JAX package's.

The classes of ``tests/bases/test_async_sync.py`` on ``LoopbackBackend`` and
``ChaosBackend``: ``sync_async()`` starts one packed round on the background
worker and returns at once, the delta cache's token orders the fold, and the
catch-up barrier inside ``sync``/``compute`` makes the value bitwise that of
a purely synchronous history, for every state kind (sum, mean, max, min,
cat, sketch).  Each value is also held bitwise against the JAX package's
async result on the same inputs (float64-canonical bytes, NaN positions
included).  Then a fault falls back to a full gather, ``reset`` drops a
stale round, both kill switches work, ``forward`` overlaps in async mode,
``MetricCollection.sync_async`` and its overlap roll-up, and two gloo ranks
(:func:`_rank_async`) whose async rounds run over the worker's own process
group while the main thread syncs other metrics.
"""

import json
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

import metrics_tpu_torch as mt
import metrics_tpu_torch.parallel as tp
from metrics_tpu_torch import obs
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

if __name__ != "__main__":  # the gloo ranks run this file as a script, without JAX
    import metrics_tpu as jm
    import metrics_tpu.parallel as jp
    from metrics_tpu import obs as jobs

ROOT = Path(__file__).resolve().parents[1]
EAGER = {"jit_update": False, "jit_compute": False}


@pytest.fixture(autouse=True)
def _fresh_obs():
    for registry in (obs, jobs):
        registry.reset()
        registry.disable()
    yield
    for registry in (obs, jobs):
        registry.reset()
        registry.disable()


class DummyListMetric(mt.Metric):
    full_state_update = True

    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("x", [], dist_reduce_fx="cat")

    def update(self, x=None):
        if x is not None:
            self.x.append(torch.as_tensor(x, dtype=torch.float32))

    def compute(self):
        return self.x


def _bits(value):
    """NaN-aware bit pattern of a computed value (float64 canonical; a list state's entries concatenated)."""
    if isinstance(value, list):
        value = torch.cat([torch.atleast_1d(v) for v in value]) if value else torch.zeros(0)
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.asarray(value, np.float64).tobytes()


def _drive_async(m, batches):
    """update + sync_async per step (every handle must be real), then compute."""
    for batch in batches:
        m.update(batch)
        assert m.sync_async() is not None
    return m.compute()


SKETCH = {"capacity": 8, "max_items": 1 << 9}  # a small sketch: the JAX fold compiles per shape
FACTORIES = {
    "sum": ("SumMetric", lambda step: np.float32(1.5 * step + 0.25)),
    "mean": ("MeanMetric", lambda step: np.asarray([step + 0.5, 2.0 * step], np.float32)),
    "max": ("MaxMetric", lambda step: np.float32(float(step % 3) - 1.0)),
    "min": ("MinMetric", lambda step: np.float32(-float(step) / 3.0)),
    "cat": ("CatMetric", lambda step: np.arange(4.0, dtype=np.float32) + 10.0 * step),
    "cat_nan": ("CatMetric", lambda step: np.asarray([step, np.nan, -step], np.float32)),
    "sketch": ("StreamingQuantile", lambda step: np.arange(8.0, dtype=np.float32) * (step + 1)),
}


class TestAsyncSyncEquivalence:
    @pytest.mark.parametrize("kind", sorted(FACTORIES))
    def test_bitwise_identical_to_synchronous_and_jax(self, kind):
        import jax.numpy as jnp

        name, make = FACTORIES[kind]
        kwargs = SKETCH if kind == "sketch" else {}
        batches = [make(step) for step in range(4)]
        port_cls = getattr(mt, name)
        async_val = _drive_async(
            port_cls(sync_backend=tp.LoopbackBackend(), device="cpu", **kwargs), [torch.as_tensor(b) for b in batches]
        )
        sync_m = port_cls(sync_backend=tp.LoopbackBackend(), device="cpu", **kwargs)
        for batch in batches:
            sync_m.update(torch.as_tensor(batch))
        assert _bits(async_val) == _bits(sync_m.compute())
        jax_val = _drive_async(
            getattr(jm, name)(sync_backend=jp.LoopbackBackend(), **EAGER, **kwargs), [jnp.asarray(b) for b in batches]
        )
        assert _bits(async_val) == _bits(jax_val)
        assert obs.summarize_counters()["sync"]["async_rounds"] == 4

    def test_async_rounds_advance_the_delta_cache(self):
        m = DummyListMetric(sync_backend=tp.LoopbackBackend())
        for step in range(3):
            m.update(torch.arange(4.0) + step)
            handle = m.sync_async()
            assert handle is not None
            handle.wait()
        m.sync_async().wait()
        rep = m.last_sync_report
        assert rep["async"] is True and rep["delta_round"] >= 2
        m.compute()
        assert m.last_sync_report["delta"] is True
        # the fold's watermark references: the rows the round gathered
        assert m._delta_cache.watermarks == {"x": 12}

    def test_interleaved_async_and_sync_rounds(self):
        m = DummyListMetric(sync_backend=tp.LoopbackBackend())
        twin = DummyListMetric(sync_backend=tp.LoopbackBackend())
        for step in range(4):
            batch = torch.arange(3.0) + 7.0 * step
            m.update(batch)
            twin.update(batch)
            if step % 2 == 0:
                assert m.sync_async() is not None
            else:
                m.compute()
                m._computed = None
            twin.compute()
            twin._computed = None
        assert _bits(m.compute()) == _bits(twin.compute())

    def test_bytes_and_reports_match_jax(self):
        import jax.numpy as jnp

        seen = {}
        for pkg, par, make, extra in ((mt, tp, torch.as_tensor, {"device": "cpu"}), (jm, jp, jnp.asarray, EAGER)):
            m = pkg.CatMetric(sync_backend=par.LoopbackBackend(), **extra)
            reports = []
            for step in range(3):
                m.update(make(np.arange(5, dtype=np.float32) + step))
                m.sync_async().wait()
            m.compute()
            for rep in m.sync_report_history:
                reports.append({k: rep.get(k) for k in ("async", "delta", "delta_round", "bytes_gathered", "bytes_saved", "gather_calls", "preflight_bytes")})
            seen[pkg.__name__] = reports
        assert seen["metrics_tpu_torch"] == seen["metrics_tpu"]


class TestOverlapAndCounters:
    def test_submit_returns_promptly_under_stall(self):
        chaos = tp.ChaosBackend(tp.LoopbackBackend(), packed=True, stall_secs=0.15)
        m = mt.CatMetric(sync_backend=chaos, device="cpu")
        m.update(torch.arange(8.0))
        t0 = time.perf_counter()
        handle = m.sync_async()
        submit_secs = time.perf_counter() - t0
        assert handle is not None
        assert submit_secs < 0.1, f"submit blocked {submit_secs:.3f}s"
        assert handle.wait(10.0)
        m.update(torch.arange(8.0) + 8.0)
        m.compute()
        fold = next(r for r in m.sync_report_history if r.get("async"))
        assert fold["overlap_secs"] > 0.1
        summary = obs.summarize_counters()["sync"]
        assert summary["async_rounds"] >= 1 and summary["overlap_secs"] > 0.1

    def test_a_cpu_metric_makes_no_side_stream(self, monkeypatch):
        import metrics_tpu_torch.metric as core

        monkeypatch.setattr(core, "_WORKER_STREAMS", {})
        m = mt.CatMetric(device="cpu")
        m.to_device("cpu")
        assert core._side_stream(m.device) is None and not core._WORKER_STREAMS

    def test_catchup_barrier_counts_when_round_is_slow(self):
        chaos = tp.ChaosBackend(tp.LoopbackBackend(), packed=True, stall_secs=0.1)
        m = mt.CatMetric(sync_backend=chaos, device="cpu")
        m.update(torch.arange(4.0))
        assert m.sync_async() is not None
        m.compute()
        assert obs.summarize_counters()["sync"]["catchup_barriers"] >= 1

    def test_counters_round_trip_through_prometheus(self):
        m = mt.CatMetric(sync_backend=tp.LoopbackBackend(), device="cpu")
        m.update(torch.arange(4.0))
        assert m.sync_async() is not None
        m.compute()
        parsed = obs.parse_prometheus_text(obs.prometheus_text())
        series = [v for (name, _), v in parsed.items() if name == "metrics_tpu_sync_async_rounds_total"]
        assert series and sum(series) >= 1
        assert isinstance(obs.summarize_counters()["sync"].get("overlap_secs", 0.0), float)


class TestFailureSemantics:
    def test_fault_during_async_falls_back_to_full_gather(self):
        chaos = tp.ChaosBackend(tp.LoopbackBackend(), packed=True, schedule={0: "error"}, fault_exception="sync_error")
        m = DummyListMetric(sync_backend=chaos)
        twin = DummyListMetric(sync_backend=tp.LoopbackBackend())
        batch = torch.arange(5.0)
        m.update(batch)
        twin.update(batch)
        handle = m.sync_async()
        assert handle is not None
        handle.wait()
        assert handle.error is not None
        value = m.compute()
        fold = next(r for r in m.sync_report_history if r.get("async"))
        assert "ChaosInjectedSyncError" in fold["error"]
        assert fold["fallback"] == "full_gather"
        assert m.last_sync_report["delta"] is False
        assert _bits(value) == _bits(twin.compute())
        assert obs.summarize_counters()["chaos_faults"] == 1

    def test_reset_discards_stale_round(self):
        m = DummyListMetric(sync_backend=tp.LoopbackBackend())
        m.update(torch.arange(4.0))
        handle = m.sync_async()
        assert handle is not None
        handle.wait()
        generation = m._delta_cache.generation
        m.reset()
        assert m._delta_cache.inflight is None and m._delta_cache.generation == generation + 1
        m.update(torch.arange(2.0) + 100.0)
        value = m.compute()
        assert _bits(value) == _bits(np.arange(2.0) + 100.0)
        assert m.last_sync_report["delta"] is False

    def test_clear_while_in_flight_drops_the_round(self):
        chaos = tp.ChaosBackend(tp.LoopbackBackend(), packed=True, stall_secs=0.05)
        m = DummyListMetric(sync_backend=chaos)
        m.update(torch.arange(3.0))
        handle = m.sync_async()
        inflight = m._delta_cache.inflight
        m._delta_cache.clear()
        m._delta_cache.inflight = inflight  # parked, but from an older generation
        handle.wait()
        m.compute()
        assert not any(r.get("async") for r in m.sync_report_history)
        assert m.last_sync_report["delta"] is False

    def test_worker_survives_a_failed_round(self):
        chaos = tp.ChaosBackend(tp.LoopbackBackend(), packed=True, schedule={0: "error"}, fault_exception="sync_error")
        bad = mt.CatMetric(sync_backend=chaos, device="cpu")
        bad.update(torch.arange(3.0))
        h1 = bad.sync_async()
        assert h1 is not None and h1.wait(10.0)
        good = mt.CatMetric(sync_backend=tp.LoopbackBackend(), device="cpu")
        good.update(torch.arange(3.0))
        h2 = good.sync_async()
        assert h2 is not None and h2.wait(10.0)
        assert h2.error is None

    def test_sync_async_on_a_synced_metric_raises(self):
        m = mt.CatMetric(sync_backend=tp.LoopbackBackend(), device="cpu")
        m.update(torch.arange(3.0))
        m.sync()
        with pytest.raises(MetricsTPUUserError):
            m.sync_async()


class TestKillSwitch:
    def test_env_kill_switch(self, monkeypatch):
        monkeypatch.setenv("METRICS_TPU_ASYNC_SYNC", "0")
        m = mt.CatMetric(sync_backend=tp.LoopbackBackend(), device="cpu")
        assert m.async_sync is False
        m.update(torch.arange(3.0))
        assert m.sync_async() is None

    def test_kwarg_kill_switch(self):
        m = mt.CatMetric(sync_backend=tp.LoopbackBackend(), async_sync=False, device="cpu")
        m.update(torch.arange(3.0))
        assert m.sync_async() is None

    @pytest.mark.parametrize("backend", ["null", "custom_fn", "unpacked_chaos"])
    def test_ineligible_backend_declines(self, backend):
        kwargs = {
            "null": {"sync_backend": tp.NullBackend()},
            "custom_fn": {"sync_backend": tp.LoopbackBackend(), "dist_sync_fn": lambda state, fns, b: state},
            "unpacked_chaos": {"sync_backend": tp.ChaosBackend(tp.LoopbackBackend())},
        }[backend]
        m = mt.CatMetric(device="cpu", **kwargs)
        m.update(torch.arange(3.0))
        assert m.sync_async() is None

    def test_flags(self):
        assert tp.LoopbackBackend.supports_async and tp.DistBackend.supports_async
        assert not tp.Backend.supports_async and not tp.NullBackend.supports_async
        assert tp.ChaosBackend(tp.LoopbackBackend()).supports_async
        assert not tp.ChaosBackend(tp.NullBackend()).supports_async


class TestForwardAsyncMode:
    def test_forward_overlaps_and_compute_matches_sync(self):
        m = mt.CatMetric(sync_backend=tp.LoopbackBackend(), dist_sync_on_step=True, async_sync=True, device="cpu")
        twin = mt.CatMetric(sync_backend=tp.LoopbackBackend(), dist_sync_on_step=True, device="cpu")
        for step in range(3):
            batch = torch.arange(4.0) + 10.0 * step
            np.testing.assert_array_equal(m(batch).numpy(), batch.numpy())  # the local batch value
            twin(batch)
        assert _bits(m.compute()) == _bits(twin.compute())
        assert obs.summarize_counters()["sync"]["async_rounds"] == 3

    def test_forward_stays_synchronous_without_optin(self):
        m = mt.CatMetric(sync_backend=tp.LoopbackBackend(), dist_sync_on_step=True, device="cpu")
        m(torch.arange(3.0))
        assert m._delta_cache.inflight is None
        assert obs.summarize_counters().get("sync", {}).get("async_rounds", 0) == 0


class TestCollections:
    @staticmethod
    def _pair():
        return mt.MetricCollection(
            {"cat": mt.CatMetric(sync_backend=tp.LoopbackBackend(), device="cpu"),
             "total": mt.SumMetric(sync_backend=tp.LoopbackBackend(), device="cpu")},
            device="cpu",
        )

    def test_collection_sync_async_returns_handles(self):
        col = self._pair()
        col.update(torch.arange(4.0))
        handles = col.sync_async()
        assert set(handles) == {"cat", "total"}
        for handle in handles.values():
            assert handle is None or handle.wait(10.0)
        vals = col.compute()
        twin = self._pair()
        twin.update(torch.arange(4.0))
        twin_vals = twin.compute()
        for key in vals:
            assert _bits(vals[key]) == _bits(twin_vals[key])

    def test_one_round_per_compute_group_leader(self):
        col = mt.MetricCollection(
            {"a": mt.CatMetric(sync_backend=tp.LoopbackBackend(), device="cpu"),
             "b": mt.CatMetric(sync_backend=tp.LoopbackBackend(), device="cpu")},
            device="cpu",
        )
        col.update(torch.arange(4.0))
        assert col.compute_groups == {0: ["a", "b"]}
        handles = col.sync_async()
        assert list(handles) == ["a"] and handles["a"].wait(10.0)
        assert col["b"]._delta_cache.inflight is not None  # the group's one cache
        vals = col.compute()
        assert _bits(vals["a"]) == _bits(vals["b"]) == _bits(np.arange(4.0))

    def test_aggregate_report_rolls_up_overlap(self):
        chaos = tp.ChaosBackend(tp.LoopbackBackend(), packed=True, stall_secs=0.05)
        col = mt.MetricCollection({"cat": mt.CatMetric(sync_backend=chaos, device="cpu")}, device="cpu")
        col.update(torch.arange(4.0))
        handles = col.sync_async()
        assert handles["cat"] is not None
        handles["cat"].wait(10.0)
        col["cat"].sync_async().wait(10.0)  # folds the first round
        assert col.aggregate_sync_report()["overlap_secs"] > 0.0


class TestThreadSafety:
    def test_reports_keep_their_own_round_under_thread_switching(self):
        """Rounds on the worker while the caller's thread syncs other metrics over the same backend,
        switching threads every microsecond: every report, folded round or synchronous sync, counts
        exactly its own two preflight and two packed gathers, and no counter loses an update."""
        backend = tp.LoopbackBackend()
        metrics = [mt.CatMetric(sync_backend=backend, device="cpu") for _ in range(6)]
        side = mt.SumMetric(sync_backend=backend, device="cpu")
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        start = time.monotonic()
        try:
            for step in range(5):
                for m in metrics:
                    m.update(torch.arange(3.0) + step)
                    assert m.sync_async() is not None
                    side.update(1.0)
                    side.compute()  # a synchronous sync on this thread while the worker runs
                    side._computed = None
            values = [m.compute() for m in metrics]
        finally:
            sys.setswitchinterval(old)
        assert time.monotonic() - start < 60
        reports = [r for m in metrics + [side] for r in m.sync_report_history]
        assert all((r["gather_calls"], r["preflight_calls"]) == (2, 2) for r in reports), reports
        assert all(_bits(v) == _bits(values[0]) for v in values)
        summary = obs.summarize_counters()["sync"]
        assert summary["async_rounds"] == 30
        assert summary["reports"] == 30 + 30 + 6  # the folds, the side syncs, the final computes
        assert summary["gather_calls"] == 2 * summary["reports"]


# ----------------------------------------------------------- two gloo ranks
WORLD = 2
ROUNDS = 4


def _rank_async(rank: int, out: Path) -> None:
    """Each round: update a cat and a buffer metric, start their async
    rounds, and sync a third metric and the cat's synchronous twin on the
    main thread while they run; compute everything at the end (the catch-up
    barriers)."""
    import metrics_tpu_torch as mt

    cat = mt.CatMetric(device="cpu")
    auroc = mt.AUROC(num_classes=3, device="cpu")
    side = mt.SumMetric(device="cpu")
    twin = mt.CatMetric(device="cpu", async_sync=False)
    rng = np.random.default_rng(rank)
    side_values = []
    for rnd in range(ROUNDS):
        rows = torch.from_numpy(rng.random(3 + rank + rnd).astype(np.float32))
        cat.update(rows)
        twin.update(rows)
        probs = torch.softmax(torch.from_numpy(rng.random((5, 3)).astype(np.float32)), 1)
        auroc.update(probs, torch.from_numpy(rng.integers(0, 3, 5)))
        assert cat.sync_async() is not None and auroc.sync_async() is not None
        side.update(float(rank + rnd))
        side_values.append(float(side.compute()))  # main-thread gathers while the rounds run
        side._computed = None
        twin.compute()  # the synchronous history: its delta rounds give the same row order
        twin._computed = None
    value, twin_value = cat.compute(), twin.compute()
    (out / f"rank{rank}.json").write_text(json.dumps({
        "bitwise": _bits(value) == _bits(twin_value),
        "value": value.tolist(),
        "auroc": float(auroc.compute()),
        "side": side_values,
        "delta": cat.last_sync_report["delta"],
        "async_reports": sum(1 for r in cat.sync_report_history if r.get("async")),
    }))


def _worker(rank: int, store_path: str, out: Path) -> None:
    import torch.distributed as dist

    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD, timeout=timedelta(seconds=30))
    _rank_async(rank, out)
    dist.destroy_process_group()


def _run_two_gloo_ranks(tmp_path, **extra_env):
    out = tmp_path / "out"
    out.mkdir()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1", **extra_env}
    procs = [
        subprocess.Popen([sys.executable, __file__, str(r), str(tmp_path / "store"), str(out)], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)
    ]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=90)[0].decode())
        except subprocess.TimeoutExpired:
            p.kill()
            logs.append(p.communicate()[0].decode())
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    seen = [json.loads((out / f"rank{r}.json").read_text()) for r in range(WORLD)]
    assert all(s["bitwise"] for s in seen)
    assert seen[0]["value"] == seen[1]["value"] and seen[0]["auroc"] == seen[1]["auroc"]
    # the union of both ranks' rows, synced synchronously in one process, for reference
    rows = []
    for rank in range(WORLD):
        rng = np.random.default_rng(rank)
        for rnd in range(ROUNDS):
            rows.append(rng.random(3 + rank + rnd).astype(np.float32))
            rng.random((5, 3))
            rng.integers(0, 3, 5)
    assert sorted(seen[0]["value"]) == sorted(np.concatenate(rows).tolist())
    expected_side = [float(sum(r + rnd for r in range(WORLD) for rnd in range(k + 1))) for k in range(ROUNDS)]
    assert seen[0]["side"] == seen[1]["side"] == expected_side
    assert all(s["async_reports"] == ROUNDS and s["delta"] for s in seen)


def test_two_gloo_ranks(tmp_path):
    _run_two_gloo_ranks(tmp_path)


def test_two_gloo_ranks_under_the_watchdog(tmp_path):
    """With a sync timeout every gather runs on a watchdog thread; the worker's
    rounds must still go over their own process group, apart from the
    main thread's syncs of ``side``."""
    _run_two_gloo_ranks(tmp_path, METRICS_TPU_SYNC_TIMEOUT="20")


# ------------------------------------------- exit after destroy_process_group
EXIT_PAIRS = 6  # two-rank worlds started at once: the abort showed in about one rank in seven under load


def _exit_worker(rank: int, store_path: str) -> None:
    """One async round, the usual DDP teardown, then a plain interpreter exit."""
    import torch.distributed as dist

    import metrics_tpu_torch as mt

    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD, timeout=timedelta(seconds=30))
    cat = mt.CatMetric(device="cpu")
    cat.update(torch.arange(3.0) + rank)
    assert cat.sync_async() is not None
    assert cat.compute().numel() == 3 * WORLD
    dist.destroy_process_group()


def test_ranks_exit_cleanly_after_async_rounds_and_destroy_process_group(tmp_path):
    """The async worker's process group must not outlive the interpreter's teardown: held
    past ``destroy_process_group()``, a gloo group destroyed during finalization aborted
    the process ("terminate called without an active exception", exit code -6)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    procs = []
    for pair in range(EXIT_PAIRS):
        store = tmp_path / f"store{pair}"
        procs += [subprocess.Popen([sys.executable, __file__, "--exit", str(rank), str(store)], env=env,
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for rank in range(WORLD)]
    results = []
    for p in procs:
        try:
            out = p.communicate(timeout=90)[0].decode()
        except subprocess.TimeoutExpired:
            p.kill()
            out = p.communicate()[0].decode()
        results.append((p.returncode, out))
    assert all(code == 0 for code, _ in results), [(code, out[-500:]) for code, out in results if code != 0]


def test_the_exit_hook_destroys_a_live_async_group_and_releases_a_destroyed_one(tmp_path):
    import torch.distributed as dist

    from metrics_tpu_torch.parallel import backend as tb

    for destroy_first in (False, True):
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s{int(destroy_first)}", rank=0, world_size=1)
        try:
            group = tb.DistBackend().for_async().group
            assert dist.get_process_group_ranks(group) == [0]
            if destroy_first:
                dist.destroy_process_group()
            tb._release_async_groups()
            assert tb._ASYNC_GROUPS == {}
            if not destroy_first:
                with pytest.raises(ValueError):
                    dist.destroy_process_group(group)  # already destroyed by the hook
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "--exit":
        _exit_worker(int(sys.argv[2]), sys.argv[3])
    else:
        _worker(int(sys.argv[1]), sys.argv[2], Path(sys.argv[3]))
