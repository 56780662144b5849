"""Buffer states in the port's ``Metric`` core, against the JAX package's, on the CPU.

A buffer state is a padded ``<name>__buf`` (256 rows at first, doubled as
it fills) and a row count ``<name>__len``.  The same appends go through a
``metrics_tpu`` metric and its port; the layout (capacity, dtype, count),
the valid rows, the schema signatures and the packed sync blob must be equal
(rows and bytes bitwise), through update, forward on both paths, reset,
clone, pickle, ``state_dict``/``state_pytree``, compute groups, sync and
``load_jax_state``.  Curve values compare to ``rtol=1e-6`` (float32 sums in
another order); rows, counts and bytes exactly.

The two-rank case runs this file as a script (``python
tests/test_torch_buffer_states.py RANK STORE OUT``) in two gloo processes.
"""

import json
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
N, C = 90, 4
EAGER = {"jit_update": False, "jit_compute": False}
RTOL = 1e-6
LAUNCH_LIMIT = 60.0


def _batches(seed: int = 0, sizes=(40, 30, 20)):
    rng = np.random.default_rng(seed)
    return [((rng.integers(0, 9, (n, C)) / 8).astype(np.float32), rng.integers(0, C, n)) for n in sizes]


def _rows_metric(pkg, full_state_update: bool = False, **kwargs):
    """A metric of one buffer state that appends its input rows; compute sums them."""

    class Rows(pkg.Metric):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.add_buffer_state("rows", persistent=True)

        def update(self, x):
            self._buffer_append("rows", x)

        def compute(self):
            return self.buffer_values("rows").sum(0)

    Rows.full_state_update = full_state_update
    return Rows(**kwargs)


def _pair(**kwargs):
    import metrics_tpu as jm
    import metrics_tpu_torch as mt

    return _rows_metric(jm, **kwargs, **EAGER), _rows_metric(mt, **kwargs, device="cpu")


def _layout(metric, name="rows"):
    """(capacity, trailing shape, dtype name, count, valid rows) of a buffer state."""
    state = metric._state if hasattr(metric, "_state") else {k: getattr(metric, k) for k in metric._defaults}
    buf, count = np.asarray(state[name + "__buf"]), int(state[name + "__len"])
    return buf.shape[0], buf.shape[1:], buf.dtype.name, count, buf[:count]


def assert_same_layout(port, ref, name="rows"):
    got, want = _layout(port, name), _layout(ref, name)
    assert got[:4] == want[:4], (got[:4], want[:4])
    np.testing.assert_array_equal(got[4], want[4])
    assert got[4].dtype == want[4].dtype


def _both_update(ref, port, x):
    import jax.numpy as jnp

    ref.update(jnp.asarray(x))
    port.update(torch.from_numpy(np.asarray(x)))


# ----------------------------------------------------------------- appends
def test_append_grows_past_256_rows_by_doubling_like_jax():
    ref, port = _pair()
    assert_same_layout(port, ref)  # the (0,) float32 placeholder
    for rows in (100, 100, 100, 300):
        _both_update(ref, port, np.arange(rows * 3, dtype=np.float32).reshape(rows, 3))
        assert_same_layout(port, ref)
    assert port.rows__buf.shape == (1024, 3) and port.rows__len == 600


def test_int64_rows_are_held_as_int32_and_promote_to_float32_like_jax():
    ref, port = _pair()
    _both_update(ref, port, np.arange(5, dtype=np.int64))
    assert_same_layout(port, ref)
    assert port.rows__buf.dtype == torch.int32
    _both_update(ref, port, np.array([0.5, 1.5], np.float64))
    assert_same_layout(port, ref)
    assert port.rows__buf.dtype == torch.float32
    np.testing.assert_array_equal(port.buffer_values("rows").numpy(), [0, 1, 2, 3, 4, 0.5, 1.5])


def test_reset_keeps_the_grown_capacity_like_jax():
    ref, port = _pair()
    _both_update(ref, port, np.ones((300, 2), np.float32))
    for m in (ref, port):
        m.reset()
    assert_same_layout(port, ref)
    assert port.rows__buf.shape == (512, 2) and port.rows__len == 0
    _both_update(ref, port, np.ones((10, 2), np.float32))
    assert_same_layout(port, ref)


@pytest.mark.parametrize("copy", ["clone", "pickle"])
def test_clone_and_pickle_mid_stream_then_continue(copy):
    import jax.numpy as jnp

    import metrics_tpu as jm
    import metrics_tpu_torch as mt

    ref, port = jm.AUC(**EAGER), mt.AUC(device="cpu")
    x = np.arange(150, dtype=np.float32) / 8
    y = (np.random.default_rng(0).integers(0, 9, 150) / 8).astype(np.float32)
    parts = [slice(0, 50), slice(50, 100), slice(100, 150)]
    ref.update(jnp.asarray(x[parts[0]]), jnp.asarray(y[parts[0]]))
    port.update(torch.from_numpy(x[parts[0]]), torch.from_numpy(y[parts[0]]))
    twin = port.clone() if copy == "clone" else pickle.loads(pickle.dumps(port))
    for part in parts[1:]:
        ref.update(jnp.asarray(x[part]), jnp.asarray(y[part]))
        for m in (port, twin):
            m.update(torch.from_numpy(x[part]), torch.from_numpy(y[part]))
    for m in (port, twin):
        assert_same_layout(m, ref, "x")
        assert_same_layout(m, ref, "y")
        np.testing.assert_allclose(m.compute().numpy(), np.asarray(ref.compute()), rtol=RTOL)


def test_state_dict_and_state_pytree_are_trimmed_and_load_back():
    ref, port = _pair()
    _both_update(ref, port, np.arange(20, dtype=np.float32).reshape(10, 2))
    tree = port.state_pytree()
    want = ref.state_pytree()
    assert tree["rows__buf"].shape == (10, 2) and tree["rows__len"].dtype == torch.int32
    np.testing.assert_array_equal(tree["rows__buf"].numpy(), np.asarray(want["rows__buf"]))
    assert int(tree["rows__len"]) == int(want["rows__len"])
    sd = port.state_dict()
    assert sd["rows__buf"].shape == (10, 2) and int(sd["rows__len"]) == 10
    for load in ("load_state_pytree", "load_state_dict"):
        fresh = _rows_metric(__import__("metrics_tpu_torch"), device="cpu")
        getattr(fresh, load)(tree if load == "load_state_pytree" else sd)
        fresh.update(torch.ones((3, 2)))
        np.testing.assert_array_equal(fresh.buffer_values("rows").numpy()[:10], np.arange(20).reshape(10, 2))
        assert fresh.rows__len == 13
    assert int(tree["rows__len"]) == 10 and tree["rows__buf"].shape == (10, 2)  # the loaded tree stays as it was


@pytest.mark.parametrize("full_state_update", [False, True], ids=["reduce_state_path", "full_state_path"])
def test_forward_on_both_paths_matches_jax(full_state_update):
    import jax.numpy as jnp

    ref, port = _pair(full_state_update=full_state_update)
    for x, _ in _batches(seed=1):
        want = ref(jnp.asarray(x))
        got = port(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert_same_layout(port, ref)
    np.testing.assert_array_equal(port.compute().numpy(), np.asarray(ref.compute()))


# ------------------------------------------------------------------ schema
def test_schema_signatures_equal_the_jax_package():
    import jax.numpy as jnp

    import metrics_tpu as jm
    import metrics_tpu.parallel as jp
    import metrics_tpu_torch as mt
    import metrics_tpu_torch.parallel as tp

    ref, port = jm.AUROC(num_classes=C, **EAGER), mt.AUROC(num_classes=C, device="cpu")
    assert port._schema_entries() == ref._schema_entries() == [("preds", "buffer:?:None"), ("target", "buffer:?:None")]
    x, t = _batches()[0]
    ref.update(jnp.asarray(x), jnp.asarray(t))
    port.update(torch.from_numpy(x), torch.from_numpy(t))
    entries = port._schema_entries()
    assert entries == ref._schema_entries() == [("preds", f"buffer:({C},):float32"), ("target", "buffer:():int32")]
    np.testing.assert_array_equal(tp.schema_digest_rows(entries), jp.schema_digest_rows(entries))


# ------------------------------------------------------------------- sync
def _recording(parallel, packed: bool = True):
    class Recording(parallel.LoopbackBackend):
        supports_packed = packed

        def __init__(self):
            super().__init__()
            self.blobs = []

        def all_gather_bytes(self, payload):
            self.blobs.append(payload)
            return super().all_gather_bytes(payload)

    return Recording()


@pytest.mark.parametrize("packed", [True, False], ids=["packed_blob", "per_state"])
def test_auroc_sync_equals_the_jax_package(packed):
    """The packed blob of an AUROC state is the JAX package's byte for byte; both
    transports give the same gathered rows, report and value."""
    import jax.numpy as jnp

    import metrics_tpu as jm
    import metrics_tpu.parallel as jp
    import metrics_tpu_torch as mt
    import metrics_tpu_torch.parallel as tp

    jb, tb = _recording(jp, packed), _recording(tp, packed)
    ref = jm.AUROC(num_classes=C, sync_backend=jb, **EAGER)
    port = mt.AUROC(num_classes=C, sync_backend=tb, device="cpu")
    for x, t in _batches(seed=2):
        ref.update(jnp.asarray(x), jnp.asarray(t))
        port.update(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(port.compute().numpy(), np.asarray(ref.compute()), rtol=RTOL)
    assert tb.blobs == jb.blobs and len(tb.blobs) == int(packed)
    for key in ("gather_calls", "bytes_gathered", "preflight_calls", "preflight_bytes", "delta"):
        assert port.last_sync_report[key] == ref.last_sync_report[key], key
    with port.sync_context(backend=tb):
        assert port.preds__len == 90 and port.preds__buf.shape == (90, C)
        np.testing.assert_array_equal(port.buffer_values("preds").numpy(), np.concatenate([x for x, _ in _batches(seed=2)]))
    assert port.preds__buf.shape == (256, C) and not port._is_synced  # the local state is back
    assert port._delta_state_names() == [] and port.last_sync_report["delta"] is False


# ---------------------------------------------------------- compute groups
def _curve_collection(pkg, **kwargs):
    return pkg.MetricCollection(
        {"auroc": pkg.AUROC(num_classes=C, **kwargs), "ap": pkg.AveragePrecision(num_classes=C, **kwargs)},
        **({"device": "cpu"} if "device" in kwargs else {}),
    )


def test_auroc_and_average_precision_share_one_buffer_pair_like_jax():
    import jax.numpy as jnp

    import metrics_tpu as jm
    import metrics_tpu_torch as mt

    ref, port = _curve_collection(jm, **EAGER), _curve_collection(mt, device="cpu")
    for x, t in _batches(seed=3):
        ref.update(jnp.asarray(x), jnp.asarray(t))
        port.update(torch.from_numpy(x), torch.from_numpy(t))
    assert list(port.compute_groups.values()) == list(ref.compute_groups.values()) == [["ap", "auroc"]]
    for key in ("preds__buf", "target__buf"):
        assert getattr(port["auroc"], key) is getattr(port["ap"], key)
    got, want = port.compute(), ref.compute()
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=RTOL)


def test_a_direct_update_on_a_member_or_the_leader_leaves_the_other_unchanged():
    import metrics_tpu_torch as mt

    col = _curve_collection(mt, device="cpu")
    batches = _batches(seed=4, sizes=(40, 30, 20, 10))
    for x, t in batches[:2]:
        col.update(torch.from_numpy(x), torch.from_numpy(t))
    leader, member = col["ap"], col["auroc"]
    assert leader.preds__buf is member.preds__buf
    before = leader.buffer_values("preds").clone()
    member.update(*map(torch.from_numpy, batches[2]))  # a member copies the shared buffer first
    assert torch.equal(leader.buffer_values("preds"), before) and leader.preds__len == 70
    assert member.preds__len == 90 and member.preds__buf is not leader.preds__buf
    mine = member.buffer_values("preds").clone()
    leader.update(*map(torch.from_numpy, batches[3]))  # the leader writes in place past its rows
    assert torch.equal(member.buffer_values("preds"), mine)
    assert torch.equal(leader.buffer_values("preds")[:70], before) and leader.preds__len == 80
    # a snapshot taken before an in-place append still reads its own rows
    snapshot = leader.state_pytree()["preds__buf"].clone()
    view = leader.state_pytree()["preds__buf"]
    col.update(*map(torch.from_numpy, batches[0]))
    assert torch.equal(view, snapshot)


def test_forward_and_sync_caches_survive_later_appends():
    import metrics_tpu_torch as mt
    import metrics_tpu_torch.parallel as tp

    batches = _batches(seed=5)
    metric = mt.AUROC(num_classes=C, device="cpu", sync_backend=tp.LoopbackBackend())
    twin = mt.AUROC(num_classes=C, device="cpu")
    for x, t in batches:
        metric(torch.from_numpy(x), torch.from_numpy(t))
        twin.update(torch.from_numpy(x), torch.from_numpy(t))
        metric.compute()  # a sync, an unsync, and the local buffer back
        assert torch.equal(metric.buffer_values("preds"), twin.buffer_values("preds"))
    np.testing.assert_array_equal(metric.compute().numpy(), twin.compute().numpy())


# ---------------------------------------------------------------- interop
@pytest.mark.parametrize("source", ["state_pytree", "state_dict"])
def test_load_jax_state_carries_a_mid_stream_auroc_across(source):
    import jax.numpy as jnp

    import metrics_tpu as jm
    import metrics_tpu_torch as mt

    batches = _batches(seed=6)
    ref = jm.AUROC(num_classes=C, **EAGER)
    for x, t in batches[:2]:
        ref.update(jnp.asarray(x), jnp.asarray(t))
    if source == "state_dict":
        ref.persistent(True)
        state = {**ref.state_dict(), "_update_count": ref._update_count}
    else:
        state = ref.state_pytree()
    port = mt.AUROC(num_classes=C, device="cpu")
    mt.load_jax_state(port, state, ref._ckpt_extra_state())
    assert port.mode == ref.mode and port.update_count == 2 and port.preds__len == 70
    x, t = batches[2]
    ref.update(jnp.asarray(x), jnp.asarray(t))
    port.update(torch.from_numpy(x), torch.from_numpy(t))
    assert_same_layout_rows(port, ref)
    np.testing.assert_allclose(port.compute().numpy(), np.asarray(ref.compute()), rtol=RTOL)


def assert_same_layout_rows(port, ref):
    for name in ("preds", "target"):
        got, want = port.buffer_values(name).numpy(), np.asarray(ref.buffer_values(name))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_load_jax_state_still_rejects_a_tensor_state_of_another_shape():
    import metrics_tpu_torch as mt

    metric = mt.BinnedAveragePrecision(num_classes=C, thresholds=7, device="cpu")
    with pytest.raises(ValueError, match="TPs"):
        mt.load_jax_state(metric, {"TPs": np.zeros((C, 8), np.float32)})


# ----------------------------------------------------------- two gloo ranks
SHARDS = {0: (0, 2), 1: (2, 3)}


def _rank(rank: int, store_path: str, out: Path) -> None:
    import torch.distributed as dist

    import metrics_tpu_torch as mt

    store = dist.FileStore(store_path, 2)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2, timeout=timedelta(seconds=30))
    col = _curve_collection(mt, device="cpu")
    first, stop = SHARDS[rank]
    for x, t in _batches(seed=7)[first:stop]:
        col.update(torch.from_numpy(x), torch.from_numpy(t))
    local = col["auroc"].buffer_values("preds").clone()
    values = col.compute()
    with col["auroc"].sync_context():
        rows = col["auroc"].buffer_values("preds").clone()
    np.savez(out / f"rank{rank}.npz", rows=rows.numpy(), **{k: v.numpy() for k, v in values.items()})
    (out / f"rank{rank}.json").write_text(json.dumps({
        "restored": torch.equal(col["auroc"].buffer_values("preds"), local),
        "aggregate": col.aggregate_sync_report(),
    }))
    dist.destroy_process_group()


def test_two_gloo_ranks_equal_the_single_process_value(tmp_path):
    import metrics_tpu_torch as mt

    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    procs = [
        subprocess.Popen([sys.executable, __file__, str(rank), str(tmp_path / "store"), str(tmp_path)],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)
    ]
    deadline = time.monotonic() + LAUNCH_LIMIT
    try:
        logs = [p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"rank {rank} exited {proc.returncode}:\n{log}"
    single = _curve_collection(mt, device="cpu")
    for x, t in _batches(seed=7):
        single.update(torch.from_numpy(x), torch.from_numpy(t))
    want = single.compute()
    union = np.concatenate([x for x, _ in _batches(seed=7)])
    for rank in range(2):
        got = np.load(tmp_path / f"rank{rank}.npz")
        np.testing.assert_array_equal(got["rows"], union)  # rank-order concatenation
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value.numpy())
        seen = json.loads((tmp_path / f"rank{rank}.json").read_text())
        assert seen["restored"] and not seen["aggregate"]["errors"]
        assert seen["aggregate"]["members_reporting"] == 2


if __name__ == "__main__":
    _rank(int(sys.argv[1]), sys.argv[2], Path(sys.argv[3]))
