"""Metric state placed on a device mesh over two and four gloo ranks, held
against the JAX package's sharded metrics.

The test starts a world of two and a world of four ranks of this file as a
script (``python tests/test_torch_mesh_parity.py WORLD RANK STORE OUT``),
all six processes at once, meeting through a ``FileStore`` per world.  Each
rank feeds the ``torch.chunk`` piece of every batch that is its own, on two
routes:

* placed: ``Metric.shard(default_mesh(device="cpu"))``, ``update``, then
  ``compute()`` (a sync through ``MeshBackend``);
* SPMD, the route of the JAX package's ``tests/helpers/testers.py``:
  ``apply_update`` on the rank's rows, then ``apply_compute(axis_name="batch")``
  under ``axis_context("batch")`` (an ``AxisBackend``).

The references come from this process: the JAX package's metric placed with
``Metric.shard(default_mesh())`` on its 8 virtual CPU devices
(``tests/conftest.py``) and fed every batch whole; for a sketch, the JAX
package's ``kll_merge`` of the ranks' own sketches in rank order, its fold
of ``_kll_merge_two`` with each step jitted (a merged sketch depends on how
its rows were split); and the port's own unplaced
metric fed every batch whole.  Tolerances: integer states and ``max``/``min``
bitwise; float sums bitwise on inputs that are multiples of 1/8 (exact in any
order); a macro F1, a mean of per-class ratios, bitwise the port's twin and
to ``rtol=1e-6`` of the JAX package's (the packages' unplaced values are an
ulp apart); AUROC, whose rows reach it in rank order rather than batch order,
to ``rtol=1e-6``; sketch leaves bitwise leaf for leaf; mAP bitwise on integer
boxes (one update a rank, so its images keep their order).

Each rank also places rows that it fed unevenly (all on rank 0: they stay
each rank's own, and the synced view lays the whole rows out evenly, where
DTensor's own ``full_tensor()`` is safe) and drives the core methods on placed
metrics: ``half()``, ``state_dict()``, ``sync_async()`` (through
``DistBackend``, the backend a metric placed with ``install_backend=False``
keeps), pickling (this rank's shares, unpickled with a warning by this
process, which has no process group), a DTensor batch, ``reset()``, and a
restore across mesh sizes: a checkpoint encoded on
the whole world (whose blob is an unplaced twin's) restored onto a mesh of
ranks 0 and 1 (of rank 0 in the world of two), and a ``CheckpointManager``
save of a placed metric, restored placed by the ranks and unplaced, folded at
world size one, by this process.
"""

import os
import pickle
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (2, 4)
LAUNCH_LIMIT = 120.0
B, N_BATCHES, C, S = 37, 3, 10, 16
SKETCH_B = 36  # rows of a sketch batch: every world splits it evenly, so the JAX side compiles one shape a world
QUANTILE = dict(q=(0.1, 0.5, 0.9), capacity=8, max_items=1 << 12)
AUROC_RTOL = 1e-6
RATIO_RTOL = 1e-6  # a macro mean of ratios against the JAX package
SMALL = 2  # ranks of the smaller mesh a checkpoint is restored onto (1 in the world of two)


def _small(world):
    return SMALL if world > SMALL else 1


def _eighths(rng, *shape):
    return (rng.integers(-32, 33, shape) / 8).astype(np.float32)


def _data():
    """Every case's global batches, from one seed."""
    rng = np.random.default_rng(0)
    labels = [(rng.integers(0, C, B), rng.integers(0, C, B)) for _ in range(N_BATCHES)]
    probs = []
    for _ in range(N_BATCHES):
        x = rng.random((B, C)).astype(np.float32) + 1e-3
        probs.append(((x / x.sum(1, keepdims=True)).astype(np.float32), rng.integers(0, C, B)))
    values = [(_eighths(rng, B),) for _ in range(N_BATCHES)]
    streams = [(rng.integers(0, 4, B), rng.integers(0, 4, B), rng.integers(0, S, B)) for _ in range(N_BATCHES)]
    sketch = [(rng.normal(size=SKETCH_B).astype(np.float32),) for _ in range(N_BATCHES)]
    preds, targets = [], []
    for _ in range(8):  # 8 small images with integer boxes
        n_g = int(rng.integers(1, 5))
        gb = np.stack([rng.integers(0, 50, n_g), rng.integers(0, 50, n_g), rng.integers(55, 90, n_g),
                       rng.integers(55, 90, n_g)], 1).astype(np.float64)
        gl = rng.integers(0, 3, n_g)
        n_p = int(rng.integers(1, 7))
        idx = rng.integers(0, n_g, n_p)
        pb = np.clip(gb[idx] + rng.integers(-8, 9, (n_p, 4)), 0, 100)
        preds.append(dict(boxes=pb, scores=rng.random(n_p).astype(np.float32), labels=gl[idx]))
        targets.append(dict(boxes=gb, labels=gl))
    return {"labels": labels, "probs": probs, "values": values, "streams": streams, "sketch": sketch,
            "images": (preds, targets)}


def _chunk(x, world, rank):
    pieces = torch.chunk(torch.arange(len(x)), world)
    idx = pieces[rank].numpy() if rank < len(pieces) else np.zeros(0, np.int64)
    return [x[i] for i in idx] if isinstance(x, list) else x[idx]


#: case -> (the key of its batches in _data(), its metric made from a package: make(pkg, **device kwargs))
CASES = {
    "acc": ("labels", lambda pkg, **kw: pkg.Accuracy(num_classes=C, **kw)),
    "f1": ("labels", lambda pkg, **kw: pkg.F1Score(num_classes=C, average="macro", **kw)),
    "cm": ("labels", lambda pkg, **kw: pkg.ConfusionMatrix(num_classes=C, **kw)),
    "auroc": ("probs", lambda pkg, **kw: pkg.AUROC(num_classes=C, **kw)),
    "sum": ("values", lambda pkg, **kw: pkg.SumMetric(**kw)),
    "max": ("values", lambda pkg, **kw: pkg.MaxMetric(**kw)),
    "min": ("values", lambda pkg, **kw: pkg.MinMetric(**kw)),
}


def _values(prefix, value):
    if isinstance(value, dict):
        return {f"{prefix}.{k}": np.asarray(v) for k, v in value.items()}
    return {prefix: np.asarray(value)}


def _np(x):
    x = x.to_local() if hasattr(x, "to_local") else x
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ ranks
def _worker(world: int, rank: int, store_path: str, out: Path) -> None:
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial

    import metrics_tpu_torch as mt
    from metrics_tpu_torch.checkpoint.codec import arrays_to_merge_state, arrays_to_pytree, decode_metric, encode_metric
    from metrics_tpu_torch.parallel import axis_context, default_mesh, row_sharded

    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world, timeout=timedelta(seconds=60))
    mesh = default_mesh(device="cpu")
    data = _data()
    saved = {}
    t = torch.from_numpy

    def mine(batch):
        return [t(np.ascontiguousarray(_chunk(x, world, rank))) for x in batch]

    for name, (key, build) in CASES.items():
        placed = build(mt, device="cpu").shard(mesh)
        pure = build(mt, device="cpu")
        state = pure.init_state()
        for batch in data[key]:
            placed.update(*mine(batch))
            pure._pre_update(*mine(batch))  # the input case an update locks (the pure API leaves it)
            state = pure.apply_update(state, *mine(batch))
        saved[f"placed.{name}"] = _np(placed.compute())
        # between syncs the reduced leaves show as Partial DTensors, every other leaf as this rank's own
        saved[f"placements.{name}"] = np.array(all(
            isinstance(v, DTensor) and v.placements[0].is_partial()
            if placed._reduce_fns.get(k) in ("sum", "mean", "max", "min") and isinstance(v, torch.Tensor)
            else not isinstance(v, DTensor)
            for k, v in placed.state.items()
        ))
        with axis_context("batch"):
            saved[f"spmd.{name}"] = _np(pure.apply_compute(state, axis_name="batch"))

    q = mt.StreamingQuantile(device="cpu", **QUANTILE).shard(mesh)
    for batch in data["sketch"]:
        q.update(*mine(batch))
    with q.sync_context():
        for leaf, value in q.sketch_tree("sketch").items():
            saved[f"sketch.{leaf}"] = _np(value)
    saved["placed.quantile"] = _np(q.compute())

    ms = mt.MultiStreamMetric(mt.Accuracy(num_classes=4, device="cpu"), num_streams=S, device="cpu")
    mt.multistream.shard_streams(ms, mt.multistream.stream_mesh(device="cpu"))
    for preds, target, ids in data["streams"]:
        ms.update(*mine((preds, target)), stream_ids=mine((ids,))[0])
    saved["placed.streams"] = _np(ms.compute())
    saved["streams.top_k"] = _np(ms.top_k(4)[1])

    preds, targets = data["images"]
    mp = mt.MeanAveragePrecision(device="cpu", on_device=True).shard(mesh)
    mp.update(_chunk(preds, world, rank), _chunk(targets, world, rank))
    saved.update(_values("placed.map", {k: _np(v) for k, v in mp.compute().items()}))

    # rows fed unevenly (all of them on rank 0) stay each rank's own when placed; synced, the whole rows
    # show split evenly over the axis where they divide (B - 1 rows), else replicated (B rows)
    for n in (B, B - 1):
        sp = mt.SpearmanCorrCoef(device="cpu")
        if rank == 0:
            sp.update(*(t(x[:n]) for x in data["values"][0] + data["values"][1]))
        sp.shard(mesh)
        saved[f"uneven{n}.rows"] = np.array(sp.preds__len)
        with sp.sync_context():
            view = sp.state["preds__buf"]
            saved[f"uneven{n}.shard"] = np.array(view.placements == row_sharded(mesh))
            saved[f"uneven{n}.full"] = _np(view.full_tensor())
        saved[f"uneven{n}.value"] = _np(sp.compute())

    # ---- the core methods on placed metrics
    totals = [mine(b)[0] for b in data["values"]]
    half = mt.SumMetric(device="cpu").shard(mesh).half()
    for x in totals:
        half.update(x)
    saved["half"] = _np(half.compute()).astype(np.float32)
    saved["half.placement"] = np.array(half.state["sum_value"].placements == (Partial("sum"),))
    sd = mt.SumMetric(device="cpu").shard(mesh)
    sd.persistent(True)
    for x in totals:
        sd.update(x)
    saved["state_dict"] = _np(sd.state_dict()["sum_value"])
    saved["pickle.bytes"] = np.frombuffer(pickle.dumps(sd), np.uint8)
    with pytest.warns(UserWarning, match=f"rank {rank}'s share of a metric placed over {world} ranks"):
        pk = pickle.loads(pickle.dumps(sd))
    saved["pickle.local"] = np.array(pk._placement is None and type(pk.sum_value) is torch.Tensor)
    saved["pickle.synced"] = _np(pk.compute())  # an unplaced clone of the shares syncs over the group
    asy = mt.SumMetric(device="cpu").shard(mesh, install_backend=False)
    handles = []
    for x in totals:
        asy.update(x)
        handles.append(asy.sync_async())
    saved["async.started"] = np.array(all(h is not None for h in handles))
    saved["async"] = _np(asy.compute())
    saved["async.backend"] = np.array(asy.last_sync_report["backend"])
    dt = mt.SumMetric(device="cpu").shard(mesh)
    for x in totals:
        dt.update(DTensor.from_local(x, mesh, row_sharded(mesh), run_check=False))
    saved["dtensor"] = _np(dt.compute())
    acc = mt.Accuracy(num_classes=C, device="cpu").shard(mesh)
    for batch in data["labels"][:1]:
        acc.update(*mine(batch))
    acc.reset()
    for batch in data["labels"]:
        acc.update(*mine(batch))
    saved["reset"] = _np(acc.compute())

    # ---- a restore across mesh sizes
    whole = mt.Accuracy(num_classes=C, device="cpu").shard(mesh)
    summed = mt.SumMetric(device="cpu").shard(mesh)
    for batch, x in zip(data["labels"], totals):
        whole.update(*mine(batch))
        summed.update(x)
    enc, enc_sum = encode_metric(whole), encode_metric(summed)
    saved["encoded.blob"] = np.frombuffer(enc.blob, np.uint8)
    small = default_mesh(list(range(_small(world))), device="cpu")
    if rank < small.size():
        fresh = mt.Accuracy(num_classes=C, device="cpu").shard(small)
        fresh._ckpt_load_extra_state(whole._ckpt_extra_state())
        fresh.load_state_pytree(arrays_to_pytree(fresh, decode_metric(enc.blob, enc.digests).arrays))
        saved["restore.acc"] = _np(fresh.compute())
        saved["restore.mesh"] = np.array(all(v.device_mesh == small for v in fresh.state.values()))
        saved["restore.blob"] = np.array(encode_metric(fresh).blob == enc.blob)
        folded = mt.SumMetric(device="cpu").shard(small)
        folded.merge_state(arrays_to_merge_state(folded, decode_metric(enc_sum.blob, enc_sum.digests).arrays),
                           other_count=enc_sum.update_count)
        saved["restore.sum"] = _np(folded.compute())
    # a CheckpointManager save of a placed metric (its whole value in the first rank's shard), restored placed
    from metrics_tpu_torch.checkpoint import CheckpointManager

    CheckpointManager(str(out / f"ckpt{world}"), barrier_timeout=30.0).save(whole)
    again = mt.Accuracy(num_classes=C, device="cpu").shard(mesh)
    CheckpointManager(str(out / f"ckpt{world}"), barrier_timeout=30.0).restore(again)
    saved["manager.placed"] = _np(again.compute())
    np.savez(out / f"w{world}r{rank}.npz", **saved)
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------------------ test side
class _Launch:
    def __init__(self, base: Path):
        self.out = base / "out"
        self.out.mkdir()
        env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
        self.deadline = time.monotonic() + LAUNCH_LIMIT
        self.procs = {
            (world, rank): subprocess.Popen(
                [sys.executable, __file__, str(world), str(rank), str(base / f"store{world}"), str(self.out)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for world in WORLDS
            for rank in range(world)
        }
        self._ranks = None

    def ranks(self, world: int) -> list:
        if self._ranks is None:
            try:
                logs = {k: p.communicate(timeout=max(self.deadline - time.monotonic(), 1.0))[0]
                        for k, p in self.procs.items()}
            finally:
                for proc in self.procs.values():
                    proc.kill()
            for key, proc in self.procs.items():
                assert proc.returncode == 0, f"rank {key} exited {proc.returncode}:\n{logs[key]}"
            self._ranks = {key: dict(np.load(self.out / f"w{key[0]}r{key[1]}.npz")) for key in self.procs}
        return [self._ranks[(world, rank)] for rank in range(world)]


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    return _Launch(tmp_path_factory.mktemp("mesh_parity"))


@pytest.fixture(scope="module")
def want(launch):
    """The JAX package's values (computed while the ranks run)."""
    import jax
    import jax.numpy as jnp

    import metrics_tpu as jm
    from metrics_tpu.multistream import shard_streams, stream_mesh
    from metrics_tpu.parallel.mesh import default_mesh
    from metrics_tpu.streaming import sketches as jsk

    import metrics_tpu_torch as mt

    assert jax.device_count() >= 8  # tests/conftest.py forces 8 virtual CPU devices
    data = _data()
    out = {}
    for name, (key, build) in CASES.items():
        m = build(jm).shard(default_mesh())
        twin = build(mt, device="cpu")
        for batch in data[key]:
            m.update(*(jnp.asarray(x) for x in batch))
            twin.update(*(torch.from_numpy(x) for x in batch))
        out[name] = np.asarray(m.compute())
        out[f"twin.{name}"] = twin.compute().numpy()
    ms = jm.MultiStreamMetric(jm.Accuracy(num_classes=4), num_streams=S)
    shard_streams(ms, stream_mesh())
    for preds, target, ids in data["streams"]:
        ms.update(jnp.asarray(preds), jnp.asarray(target), stream_ids=jnp.asarray(ids))
    out["streams"] = np.asarray(ms.compute())
    out["streams.top_k"] = np.asarray(ms.top_k(4)[1])
    preds, targets = data["images"]
    mp = jm.MeanAveragePrecision(device=True).shard(default_mesh())
    mp.update(preds, targets)
    out.update(_values("map", {k: np.asarray(v) for k, v in mp.compute().items()}))
    values = np.concatenate([b[0] for b in data["values"]])
    out["total"] = np.float32(values.sum(dtype=np.float64))
    merge_two = jax.jit(jsk._kll_merge_two)
    for world in WORLDS:
        trees = []
        for rank in range(world):
            q = jm.StreamingQuantile(**QUANTILE)
            for batch in data["sketch"]:
                q.update(jnp.asarray(_chunk(batch[0], world, rank)))
            tree = q.state_pytree()
            trees.append({leaf: tree[f"sketch__sk_{leaf}"] for leaf in ("buf", "cnt", "key", "n", "nc")})
        # kll_merge folds the list two at a time: the same fold, each step jitted once for every world
        merged = {k: jnp.asarray(v) for k, v in trees[0].items()}
        for tree in trees[1:]:
            merged = merge_two(merged, tree)
        out[f"sketch{world}"] = {k: np.asarray(v) for k, v in merged.items()}
        q = jm.StreamingQuantile(**QUANTILE)
        q.load_state_pytree({"_update_count": 1, **{f"sketch__sk_{k}": v for k, v in merged.items()}})
        out[f"quantile{world}"] = np.asarray(q.compute())
    return out


def _same(got, want, rtol=0.0, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if rtol:
        np.testing.assert_allclose(got, want, rtol=rtol, err_msg=what)
    else:
        assert got.astype(want.dtype).tobytes() == want.tobytes(), (what, got, want)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_placed_and_spmd_routes_equal_the_jax_sharded_metric(launch, want, world, name):
    rtol = {"auroc": AUROC_RTOL, "f1": RATIO_RTOL}.get(name, 0.0)
    twin_rtol = AUROC_RTOL if name == "auroc" else 0.0
    for rank, got in enumerate(launch.ranks(world)):
        assert bool(got[f"placements.{name}"]), (name, rank)
        for route in ("placed", "spmd"):
            _same(got[f"{route}.{name}"], want[name], rtol, f"{route} {name} rank {rank}")
            _same(got[f"{route}.{name}"], want[f"twin.{name}"], twin_rtol, f"{route} {name} rank {rank} (port twin)")


@pytest.mark.parametrize("world", WORLDS)
def test_placed_sketch_leaves_are_the_rank_order_merge(launch, want, world):
    for rank, got in enumerate(launch.ranks(world)):
        for leaf, value in want[f"sketch{world}"].items():
            assert got[f"sketch.{leaf}"].dtype == value.dtype, leaf
            assert got[f"sketch.{leaf}"].tobytes() == value.tobytes(), (world, rank, leaf)
        _same(got["placed.quantile"], want[f"quantile{world}"], 0.0, f"quantile rank {rank}")


@pytest.mark.parametrize("world", WORLDS)
def test_shard_streams_and_map_equal_the_jax_sharded_metrics(launch, want, world):
    for rank, got in enumerate(launch.ranks(world)):
        _same(got["placed.streams"], want["streams"], 0.0, f"streams rank {rank}")
        _same(got["streams.top_k"], want["streams.top_k"], 0.0, f"top_k rank {rank}")
        keys = sorted(k[len("placed.map."):] for k in got if k.startswith("placed.map."))
        assert keys == sorted(k[len("map."):] for k in want if k.startswith("map."))
        for key in keys:
            _same(got[f"placed.map.{key}"], want[f"map.{key}"], 0.0, f"map {key} rank {rank}")


@pytest.mark.parametrize("world", WORLDS)
def test_core_methods_on_placed_metrics(launch, want, world):
    import metrics_tpu_torch as mt

    values = [b[0] for b in _data()["values"]]
    twin = mt.SumMetric(device="cpu").half()
    for x in values:
        twin.update(torch.from_numpy(x))
    for rank, got in enumerate(launch.ranks(world)):
        _same(got["half"], twin.compute().float(), 0.0, f"half rank {rank}")
        assert bool(got["half.placement"])
        for key in ("state_dict", "pickle.synced", "async", "dtensor"):
            _same(got[key], want["total"], 0.0, f"{key} rank {rank}")
        assert bool(got["pickle.local"]) and bool(got["async.started"])
        assert str(got["async.backend"]) == "DistBackend"
        _same(got["reset"], want["acc"], 0.0, f"reset rank {rank}")


@pytest.mark.parametrize("world", WORLDS)
def test_uneven_rows_stay_each_ranks_own_when_placed(launch, world):
    import metrics_tpu_torch as mt

    values = _data()["values"]
    for n in (B, B - 1):
        twin = mt.SpearmanCorrCoef(device="cpu")
        twin.update(*(torch.from_numpy(x[:n]) for x in values[0] + values[1]))
        for rank, got in enumerate(launch.ranks(world)):
            assert int(got[f"uneven{n}.rows"]) == (n if rank == 0 else 0), (n, rank)
            assert bool(got[f"uneven{n}.shard"]) == (n % world == 0), (n, rank)
            _same(got[f"uneven{n}.full"], values[0][0][:n], 0.0, f"synced rows {n} rank {rank}")
            _same(got[f"uneven{n}.value"], twin.compute().numpy(), 0.0, f"spearman {n} rank {rank}")


@pytest.mark.parametrize("world", WORLDS)
def test_a_pickled_placed_metric_is_its_ranks_share_without_a_process_group(launch, world):
    import torch.distributed as dist

    import metrics_tpu_torch as mt

    assert not (dist.is_available() and dist.is_initialized())
    values = [b[0] for b in _data()["values"]]
    for rank, got in enumerate(launch.ranks(world)):
        share = mt.SumMetric(device="cpu")
        for x in values:
            share.update(torch.from_numpy(np.ascontiguousarray(_chunk(x, world, rank))))
        with pytest.warns(UserWarning, match=f"rank {rank}'s share of a metric placed over {world} ranks"):
            clone = pickle.loads(got["pickle.bytes"].tobytes())
        assert clone._placement is None and clone.sync_backend is None
        _same(clone.compute(), share.compute(), 0.0, f"unpickled share rank {rank}")


@pytest.mark.parametrize("world", WORLDS)
def test_restore_onto_a_smaller_mesh(launch, want, world):
    import metrics_tpu_torch as mt
    from metrics_tpu_torch.checkpoint.codec import encode_metric

    twin = mt.Accuracy(num_classes=C, device="cpu")
    for batch in _data()["labels"]:
        twin.update(*(torch.from_numpy(x) for x in batch))
    blob = np.frombuffer(encode_metric(twin).blob, np.uint8)
    ranks = launch.ranks(world)
    small = _small(world)
    for rank, got in enumerate(ranks):
        assert got["encoded.blob"].tobytes() == blob.tobytes(), rank  # an unplaced twin's blob
        if rank >= small:
            assert "restore.acc" not in got
            continue
        _same(got["restore.acc"], want["acc"], 0.0, f"restored rank {rank}")
        assert bool(got["restore.mesh"]) and bool(got["restore.blob"])
        _same(got["restore.sum"], want["total"], 0.0, f"merged rank {rank}")
    for rank, got in enumerate(ranks):
        _same(got["manager.placed"], want["acc"], 0.0, f"manager restore of a placed metric, rank {rank}")
    from metrics_tpu_torch.checkpoint import CheckpointManager

    folded = mt.Accuracy(num_classes=C, device="cpu")
    result = CheckpointManager(str(launch.out / f"ckpt{world}"), rank=0, world_size=1).restore(folded)
    assert result.world_size == world and result.folded_shards == list(range(1, world))
    _same(folded.compute(), want["acc"], 0.0, "the placed checkpoint folded at world size one")


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4]))
