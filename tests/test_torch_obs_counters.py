"""The counters of the streaming, checkpoint and multistream layers, against the JAX package's.

Each case runs the same sequence in both packages and compares the counter
deltas (``(name, labels) -> value``) of the layer it drives, which must be
equal, value for value:

* checkpoint: ``TestCounters::test_ckpt_counters_flow_to_summary`` (two
  saves with ``keep_last=1``, a restore: ``saves``, ``restores``,
  ``bytes_written`` (the shards are byte-equal), ``gc_pruned``), a triggered
  save, the counter half of ``test_chaos_store_counts_injections``, and a
  restore past a torn step, a missing shard and a bit flip
  (``stale_manifests``, ``missing_shards``, ``digest_failures``,
  ``folded_shards``); ``LocalStore.bytes_written``/``fsyncs`` stay
  attributes;
* multistream: ``test_query.py::test_counters_flow_through_summarize_and_prometheus``
  (``scatter_updates``, ``topk_queries``, ``streams_active``), ``where``,
  ``compute_streams`` and a synced query (``sync_bytes``);
* streaming: ``sketch_compactions`` (read at a state read, once per
  update-count change, never in an update), ``window_evictions`` and
  ``sketch_merge_calls``.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import metrics_tpu as jm
import metrics_tpu.checkpoint as jc
import metrics_tpu.parallel as jp
import metrics_tpu_torch as mt
import metrics_tpu_torch.checkpoint as tc
import metrics_tpu_torch.parallel as tp
from metrics_tpu import obs as jobs
from metrics_tpu_torch import obs

EAGER = {"jit_update": False, "jit_compute": False}
S, B = 12, 40


@pytest.fixture(autouse=True)
def _fresh_obs():
    for registry in (obs, jobs):
        registry.reset()
    yield
    for registry in (obs, jobs):
        registry.reset()


def _deltas(registry, before):
    return {k: v - before.get(k, 0) for k, v in registry.counters_snapshot().items() if v != before.get(k, 0)}


def _layer(snapshot, prefix):
    return {k: v for k, v in snapshot.items() if k[0].startswith(prefix)}


PORT = {"pkg": mt, "ckpt": tc, "par": tp, "obs": obs, "make": torch.as_tensor, "kw": {"device": "cpu"}}
JAX = {"pkg": jm, "ckpt": jc, "par": jp, "obs": jobs, "make": jnp.asarray, "kw": EAGER}


def _both(run, prefix):
    """``run(side)`` in each package; returns the port's and the JAX package's deltas of ``prefix`` counters."""
    out = []
    for side in (PORT, JAX):
        before = side["obs"].counters_snapshot()
        run(side)
        out.append(_layer(_deltas(side["obs"], before), prefix))
    return out


# -------------------------------------------------------------- checkpoint
def _mgr(side, path, **kw):
    return side["ckpt"].CheckpointManager(str(path), rank=0, world_size=1, **kw)


def test_ckpt_counters_flow_to_summary(tmp_path):
    def run(side):
        root = tmp_path / side["pkg"].__name__
        m = side["pkg"].SumMetric(**side["kw"])
        m.update(side["make"](np.float32(1.0)))
        mgr = _mgr(side, root, keep_last=1)
        mgr.save(m, step=0)
        mgr.save(m, step=1)  # prunes step 0
        _mgr(side, root).restore(side["pkg"].SumMetric(**side["kw"]))
        due = _mgr(side, root, max_staleness=1e-9)
        assert due.maybe_save(m, step=2) == 2

    port, ref = _both(run, "ckpt.")
    assert port == ref
    summary = obs.summarize_counters(port)["ckpt"]
    assert summary["saves"] == 3 and summary["restores"] == 1 and summary["triggered_saves"] == 1
    assert summary["bytes_written"] > 0 and summary["gc_pruned"] >= 1


def test_local_store_keeps_its_attributes(tmp_path):
    store = tc.LocalStore(str(tmp_path))
    store.write_atomic("a/b.bin", b"12345")
    assert store.bytes_written == 5 and store.fsyncs >= 2


def test_chaos_store_counts_injections(tmp_path):
    def run(side):
        chaos = side["ckpt"].ChaosStore(
            side["ckpt"].LocalStore(str(tmp_path / side["pkg"].__name__)), faults=[("bit_flip", "x.bin")]
        )
        chaos.write_atomic("x.bin", b"hello world")
        chaos.read("x.bin")
        assert chaos.injected == [("bit_flip", "x.bin")]

    port, ref = _both(run, "ckpt.")
    assert port == ref == {("ckpt.chaos_faults", (("kind", "bit_flip"),)): 1}


def _col(side):
    pkg = side["pkg"]
    members = {"a": pkg.SumMetric(**side["kw"]), "b": pkg.CatMetric(**side["kw"])}
    return pkg.MetricCollection(members, **({"device": "cpu"} if side is PORT else {}))


def test_restore_fault_counters(tmp_path):
    """A torn manifest, a missing shard and a flipped bit on the way back."""
    def run(side):
        ckpt = side["ckpt"]
        root = tmp_path / side["pkg"].__name__
        cols = [_col(side) for _ in range(2)]
        for col in cols:
            col.update(side["make"](np.arange(3, dtype=np.float32)))
        writers = [ckpt.CheckpointManager(str(root), rank=r, world_size=2, barrier_timeout=5.0) for r in range(2)]
        _save_two_ranks(writers, cols, step=0)
        _save_two_ranks(writers, cols, step=1)
        (root / "step_00000001" / "MANIFEST.json").write_text("{torn")
        (root / "step_00000000" / "shard_00001.bin").unlink()
        reader = ckpt.CheckpointManager(str(root), rank=0, world_size=1, on_restore_error="skip_state")
        result = reader.restore(_col(side))
        assert result.step == 0 and result.missing_shards == [1] and result.stale_steps == [1]
        flip = ckpt.CheckpointManager(
            str(root), rank=0, world_size=1, on_restore_error="skip_state",
            store=ckpt.ChaosStore(ckpt.LocalStore(str(root)), faults=[("bit_flip", "shard_00000.bin")]),
        )
        flip.restore(_col(side))

    port, ref = _both(run, "ckpt.")
    assert port == ref
    names = {k[0] for k in port}
    assert {"ckpt.stale_manifests", "ckpt.missing_shards", "ckpt.chaos_faults", "ckpt.restores"} <= names


def _save_two_ranks(writers, cols, step):
    """Both ranks of a world of two save through one local store, one thread each."""
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda wc: wc[0].save(wc[1], step=step), zip(writers, cols)))


def test_folded_shards_counted(tmp_path):
    def run(side):
        pkg, ckpt = side["pkg"], side["ckpt"]
        root = tmp_path / pkg.__name__
        writers = [ckpt.CheckpointManager(str(root), rank=r, world_size=2, barrier_timeout=5.0) for r in range(2)]
        cols = []
        for r in range(2):
            m = pkg.SumMetric(**side["kw"])
            m.update(side["make"](np.float32(r + 1.0)))
            cols.append(m)
        _save_two_ranks(writers, cols, step=0)
        target = pkg.SumMetric(**side["kw"])
        ckpt.CheckpointManager(str(root), rank=0, world_size=1).restore(target)
        assert float(target.compute()) == 3.0

    port, ref = _both(run, "ckpt.")
    assert port == ref and port[("ckpt.folded_shards", ())] == 1


# ------------------------------------------------------------- multistream
def _fed_accuracy(side, seed=22):
    rng = np.random.default_rng(seed)
    preds, target, ids = rng.integers(0, 4, B), rng.integers(0, 4, B), rng.integers(0, S, B)
    pkg, make = side["pkg"], side["make"]
    m = pkg.MultiStreamMetric(pkg.Accuracy(num_classes=4, **side["kw"]), num_streams=S, **side["kw"])
    m.update(make(preds), make(target), stream_ids=make(ids))
    return m


def test_multistream_counters_flow_through_summarize_and_prometheus():
    def run(side):
        m = _fed_accuracy(side)
        m.top_k(3)
        m.where(lambda v: v > 0.25, 4)
        m.compute_streams(side["make"](np.asarray([0, 3])))
        m.update(side["make"](np.asarray([1, 2])), side["make"](np.asarray([1, 1])), stream_ids=side["make"](np.asarray([0, 1])))
        m.bottom_k(2)

    port, ref = _both(run, "multistream.")
    assert port == ref
    names = {name for name, _ in port}
    assert {"multistream.scatter_updates", "multistream.topk_queries", "multistream.streams_active"} <= names
    summary = obs.summarize_counters(port)["multistream"]
    assert summary["scatter_updates"] == 2 and summary["topk_queries"] == 3
    parsed = obs.parse_prometheus_text(obs.prometheus_text())
    series = {name: value for (name, _), value in parsed.items() if "multistream" in name}
    assert any("topk" in name for name in series) and all(v >= 1 for v in series.values())


def test_multistream_sync_bytes():
    def run(side):
        pkg, make = side["pkg"], side["make"]
        m = pkg.MultiStreamMetric(
            pkg.MeanSquaredError(**side["kw"]), num_streams=S, sync_backend=side["par"].LoopbackBackend(), **side["kw"]
        )
        rng = np.random.default_rng(3)
        m.update(make(rng.random(B).astype(np.float32)), make(rng.random(B).astype(np.float32)),
                 stream_ids=make(rng.integers(0, S, B)))
        m.top_k(2)

    port, ref = _both(run, "multistream.")
    assert port == ref and port[("multistream.sync_bytes", (("metric", "MeanSquaredError"),))] > 0


def test_streams_active_is_read_at_a_query_not_an_update():
    side = PORT
    before = obs.counters_snapshot()
    m = _fed_accuracy(side)
    assert "multistream.streams_active" not in {k[0] for k in _deltas(obs, before)}
    m.top_k(1)
    assert "multistream.streams_active" in {k[0] for k in _deltas(obs, before)}


# --------------------------------------------------------------- streaming
SKETCH = {"capacity": 8, "max_items": 1 << 9}


def test_sketch_compactions_and_merges():
    def run(side):
        pkg, make = side["pkg"], side["make"]
        m = pkg.StreamingQuantile(q=0.5, sync_backend=side["par"].LoopbackBackend(), **SKETCH, **side["kw"])
        rng = np.random.default_rng(9)
        for step in range(6):
            m.update(make(rng.random(20).astype(np.float32)))
            if step % 2:
                m.compute()
                m._computed = None

    port, ref = _both(run, "streaming.")
    assert port == ref
    assert port[("streaming.sketch_compactions", (("metric", "StreamingQuantile"),))] > 0
    assert port[("streaming.sketch_merge_calls", (("metric", "StreamingQuantile"),))] == 3


def test_sketch_compactions_are_not_read_in_an_update(monkeypatch):
    m = mt.StreamingQuantile(q=0.5, **SKETCH, device="cpu")
    reads = []
    original = type(m)._report_sketch_compactions
    monkeypatch.setattr(type(m), "_report_sketch_compactions", lambda self: reads.append(1) or original(self))
    for _ in range(5):
        m.update(torch.rand(30))
    assert reads == []
    m.compute()
    m.compute()
    assert obs.counter_value("streaming.sketch_compactions", metric="StreamingQuantile") == int(m.sketch__sk_nc)
    assert m._nc_count_mark == 5


def test_window_evictions():
    def run(side):
        pkg, make = side["pkg"], side["make"]
        w = pkg.WindowedMetric(pkg.SumMetric(**side["kw"]), window_size=2, **side["kw"])
        for step in range(5):
            w.update(make(np.float32(step)))
            w.advance()
        w.advance()  # an empty bucket evicts nothing

    port, ref = _both(run, "streaming.")
    assert port == ref == {("streaming.window_evictions", (("metric", "SumMetric"),)): 5}
