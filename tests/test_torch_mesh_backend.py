"""Metric state placed on a device mesh, one gloo rank in this process
(the port's mirror of ``tests/bases/test_mesh_backend.py``, case by case).

A placed metric's ``state`` shows each leaf as the DTensor its placement
describes: the JAX package's ``P()`` of a synced value is the port's
``(Replicate(),)`` and its ``P('batch')`` of rows is ``(Shard(0),)``; between
syncs a reduced state is ``(Partial(op),)`` (each rank's own sums) and rows
are each rank's own plain tensor.  The metric's attributes stay plain
tensors.  Mesh against loopback must be bitwise (NaN-aware): the mesh
path is a layout, never a value change.  Multi-rank worlds and the parity with
the JAX package's sharded metrics: ``tests/test_torch_mesh_parity.py``.
"""

import pickle
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

import metrics_tpu_torch as mt
from metrics_tpu_torch import obs
from metrics_tpu_torch.checkpoint.codec import arrays_to_merge_state, arrays_to_pytree, decode_metric, encode_metric
from metrics_tpu_torch.obs.exporters import parse_prometheus_text, prometheus_text
from metrics_tpu_torch.parallel import LoopbackBackend, MeshBackend, PartitionSpec as P
from metrics_tpu_torch.parallel.mesh import default_mesh, leaf_sharding, replicated, row_sharded
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError


@pytest.fixture(scope="module", autouse=True)
def world_of_one(tmp_path_factory):
    store = dist.FileStore(str(tmp_path_factory.mktemp("mesh") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1, timeout=timedelta(seconds=30))
    yield
    dist.destroy_process_group()


@pytest.fixture
def mesh():
    return default_mesh(device="cpu")


def _bits(x):
    """float64 bit patterns: NaNs with identical payloads compare equal."""
    x = x.to_local() if isinstance(x, DTensor) else x
    return np.asarray(x.detach().cpu().numpy(), dtype=np.float64).view(np.uint64)


def assert_bitwise_equal(a, b):
    ba, bb = _bits(a), _bits(b)
    assert ba.shape == bb.shape
    np.testing.assert_array_equal(ba, bb)


class _Reduced(mt.Metric):
    """One scalar state under a configurable reduce."""

    full_state_update = True
    fx = "sum"

    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        init = {"sum": 0.0, "mean": 0.0, "max": -float("inf"), "min": float("inf")}[self.fx]
        self.add_state("v", torch.tensor(init), dist_reduce_fx=self.fx)

    def update(self, x):
        x = torch.as_tensor(x, dtype=torch.float32)
        if self.fx == "sum":
            self.v = self.v + x.sum()
        elif self.fx == "mean":
            self.v = x.mean()
        elif self.fx == "max":
            self.v = torch.maximum(self.v, x.max())
        else:
            self.v = torch.minimum(self.v, x.min())

    def compute(self):
        return self.v


class _SumM(_Reduced):
    fx = "sum"


class _MeanM(_Reduced):
    fx = "mean"


class _MaxM(_Reduced):
    fx = "max"


class _MinM(_Reduced):
    fx = "min"


class _CatM(mt.Metric):
    """A cat-state metric whose compute consumes the rows (like real metrics)."""

    full_state_update = True

    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("rows", [], dist_reduce_fx="cat")

    def update(self, x):
        self.rows.append(torch.as_tensor(x, dtype=torch.float32))

    def compute(self):
        return torch.cat(self.rows) if isinstance(self.rows, list) else self.rows


class _ListM(mt.Metric):
    full_state_update = True

    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("x", [], dist_reduce_fx="cat")

    def update(self, x=None):
        if x is not None:
            self.x.append(torch.as_tensor(x, dtype=torch.float32))

    def compute(self):
        return self.x


class _DummySum(mt.Metric):
    full_state_update = True

    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("x", torch.tensor(0.0), dist_reduce_fx="sum", persistent=True)

    def update(self, x):
        self.x = self.x + torch.as_tensor(x, dtype=torch.float32)

    def compute(self):
        return self.x


def _synced_compute(m, backend=None):
    if backend is not None:
        m.sync_backend = backend
    return m.compute()  # compute syncs through the installed backend


# ---------------------------------------------------------------- equivalence


@pytest.mark.parametrize("cls", [_SumM, _MeanM, _MaxM, _MinM], ids=lambda c: c.fx)
def test_mesh_vs_loopback_bitwise_reduced(cls, mesh):
    batches = [torch.tensor([0.1, 0.2, 0.7]), torch.tensor([3.3, -1.5, 2.25])]
    mesh_m, loop_m = cls().shard(mesh), cls()
    for b in batches:
        mesh_m.update(b)
        loop_m.update(b)
    want = _synced_compute(loop_m, backend=LoopbackBackend())
    got = _synced_compute(mesh_m)
    assert_bitwise_equal(got, want)


def test_mesh_vs_loopback_bitwise_cat_with_nans(mesh):
    nan, inf = float("nan"), float("inf")
    rows = torch.tensor([1.0, nan, 0.3, -0.0, inf, 2.5, -7.0, nan])
    mesh_m, loop_m = _CatM().shard(mesh), _CatM()
    mesh_m.update(rows)
    loop_m.update(rows)
    want = _synced_compute(loop_m, backend=LoopbackBackend())
    got = _synced_compute(mesh_m)
    assert_bitwise_equal(got, want)  # identical bit patterns, the -0.0 and NaN rows too


def test_mesh_vs_loopback_bitwise_sketch(mesh):
    vals = torch.from_numpy(np.random.default_rng(3).normal(size=(256,)).astype(np.float32))
    mesh_m = mt.StreamingQuantile(q=(0.1, 0.5, 0.9), device="cpu").shard(mesh)
    loop_m = mt.StreamingQuantile(q=(0.1, 0.5, 0.9), device="cpu")
    mesh_m.update(vals)
    loop_m.update(vals)
    want = _synced_compute(loop_m, backend=LoopbackBackend())
    got = _synced_compute(mesh_m)
    assert_bitwise_equal(got, want)


def test_combined_reductions_are_bitwise_one_collective_a_state(mesh):
    # the reduced states of one reduce and dtype go in one collective, or each in its own: the same bits
    preds, target = torch.tensor([0, 1, 2, 1, 2, 0]), torch.tensor([0, 1, 1, 1, 2, 2])
    values, calls, ticks = {}, {}, {}
    for combine in (True, False):
        m = mt.Accuracy(num_classes=3, average="macro", device="cpu").shard(mesh)
        m.sync_backend.combine_reductions = combine
        m.update(preds, target)
        seen, reduce_one = [], m.sync_backend._reduce
        m.sync_backend._reduce = lambda x, fx: seen.append(fx) or reduce_one(x, fx)
        values[combine] = m.compute()
        calls[combine], ticks[combine] = len(seen), m.last_sync_report["in_xla_reductions"]
    assert_bitwise_equal(values[True], values[False])
    assert calls[True] < calls[False] == ticks[False] == ticks[True]  # one tick a state either way


# ------------------------------------------------------------------ placement


def test_shard_places_reduced_states_partial_then_replicated(mesh):
    m = _DummySum().shard(mesh)
    m.update(2.0)
    assert type(m.x) is torch.Tensor  # updates and computes run on plain tensors
    assert isinstance(m.state["x"], DTensor) and m.state["x"].placements == (Partial("sum"),)
    assert isinstance(m.sync_backend, MeshBackend)
    assert m.sync_backend.world_size() == dist.get_world_size()
    with m.sync_context():
        assert m.state["x"].placements == replicated(mesh) == (Replicate(),)  # the JAX package's P()
    assert m.state["x"].placements == (Partial("sum"),)


def test_synced_list_state_stays_a_list_and_rows_gather_replicated(mesh):
    # list states stay local lists between syncs; synced, the whole rows are
    # laid out by the spec (split evenly over the axis); row DTensors through
    # the backend come back whole and replicated
    m = _ListM().shard(mesh)
    m.update(torch.arange(8.0))
    assert isinstance(m.state["x"], list)
    with m.sync_context(distributed_available=True):
        assert m.state["x"].placements == (Shard(0),)
        np.testing.assert_allclose(m.state["x"].full_tensor().numpy(), np.arange(8.0))
    assert isinstance(m.x, list)  # unsync restored the local list state
    rows = DTensor.from_local(torch.arange(8.0), mesh, row_sharded(mesh), run_check=False)
    out = m.sync_backend.all_gather_cat(rows)
    assert out.placements == (Replicate(),)
    np.testing.assert_allclose(out.to_local().numpy(), np.arange(8.0))


def test_explicit_spec_wins_over_kind_default(mesh):
    class Pinned(mt.Metric):
        full_state_update = True

        def __init__(self):
            super().__init__(device="cpu")
            self.add_state("rows", torch.zeros((8, 4)), dist_reduce_fx="cat", spec=P("batch"))
            self.add_state("cols", torch.zeros((8, 4)), dist_reduce_fx="cat", spec=P(None, "batch"))

        def update(self):
            pass

        def compute(self):
            return self.rows

    m = Pinned().shard(mesh)
    assert not isinstance(m.state["rows"], DTensor)  # rows between syncs are each rank's own
    with m.sync_context(distributed_available=True):
        assert m.state["rows"].placements == (Shard(0),)  # the JAX package's P('batch')
        assert m.state["cols"].placements == (Shard(1),)  # the explicit spec, P(None, 'batch')


def test_add_state_sharded_spec_contradicts_scalar_reduce():
    class Bad(mt.Metric):
        def __init__(self):
            super().__init__(device="cpu")
            self.add_state("v", torch.zeros(()), dist_reduce_fx="sum", spec=P("batch"))

        def update(self):
            pass

        def compute(self):
            return self.v

    with pytest.raises(ValueError, match="contradicts"):
        Bad()


def test_add_state_spec_must_be_the_ports_partition_spec():
    class Tupled(mt.Metric):
        def __init__(self):
            super().__init__(device="cpu")
            self.add_state("rows", [], dist_reduce_fx="cat", spec=("batch",))

        def update(self):
            pass

        def compute(self):
            return self.rows

    with pytest.raises(ValueError, match="PartitionSpec"):
        Tupled()


def test_leaf_sharding_fallback_to_replication(mesh):
    n = dist.get_world_size()
    # a fitting leading dim: the spec applies
    assert leaf_sharding(mesh, torch.zeros((n * 2, 3)), P("batch")) == (Shard(0),)
    assert leaf_sharding(mesh, torch.zeros((3, n * 2)), P(None, "batch")) == (Shard(1),)
    # zero extents, rank-deficient leaves, unknown axes, no spec: replicate
    assert leaf_sharding(mesh, torch.zeros((0,)), P("batch")) == (Replicate(),)
    assert leaf_sharding(mesh, torch.zeros(()), P("batch")) == (Replicate(),)
    assert leaf_sharding(mesh, torch.zeros((n,)), P("model")) == (Replicate(),)
    assert leaf_sharding(mesh, torch.zeros((n,)), None) == (Replicate(),)


def test_mesh_backend_rejects_missing_axis():
    with pytest.raises(ValueError, match="not an axis"):
        MeshBackend(default_mesh(axis_name="batch", device="cpu"), axis_name="model")
    with pytest.raises(ValueError, match="not an axis"):
        _DummySum().shard(default_mesh(axis_name="batch", device="cpu"), axis_name="model")


def test_default_mesh_raises_without_a_process_group(monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="process group"):
        default_mesh(device="cpu")


def test_placement_survives_reset(mesh):
    m = _DummySum().shard(mesh)
    m.update(1.0)
    m.reset()
    assert m.state["x"].placements == (Partial("sum"),)
    a = mt.AUROC(num_classes=3, device="cpu").shard(mesh)
    a.update(torch.rand(10, 3).softmax(-1), torch.arange(10) % 3)
    a.reset()
    assert a._placement is not None and a.preds__len == 0
    a.update(torch.rand(10, 3).softmax(-1), torch.arange(10) % 3)
    with a.sync_context():
        assert a.state["preds__buf"].placements == (Shard(0),) and a.state["preds__len"] == 10


# ------------------------------------------------------------- sync telemetry


def test_sync_report_records_in_xla_reductions_not_wire_bytes(mesh):
    m = _DummySum().shard(mesh)
    m.update(3.0)
    m.sync()
    rep = m.last_sync_report
    m.unsync()
    assert rep["backend"] == "MeshBackend"
    assert rep["world_size"] == dist.get_world_size()
    assert rep["in_xla_reductions"] >= 1
    assert rep["gather_calls"] == 0 and rep["bytes_gathered"] == 0
    assert "preflight_calls" not in rep  # the SPMD tier has no preflight


def test_placement_stable_across_epochs(mesh):
    # the JAX package checks that steady-state epochs retrace nothing; the
    # port compiles nothing, and its steady state is the placement: epochs
    # keep every leaf's placement and place nothing anew
    m = mt.Accuracy(num_classes=3, device="cpu").shard(mesh)
    preds, target = torch.tensor([0, 1, 2, 1]), torch.tensor([0, 1, 1, 1])
    before = obs.counter_value("sync.mesh_placements", metric="Accuracy")
    for _ in range(3):
        m.update(preds, target)
        assert float(m.compute()) == 0.75
        m.reset()
        assert {k: v.placements for k, v in m.state.items()} == {k: (Partial("sum"),) for k in m.state}
    assert obs.counter_value("sync.mesh_placements", metric="Accuracy") == before


# ------------------------------------------- checkpoint -> elastic re-placement


def test_shard_checkpoint_elastic_restore_merges_and_places_again(mesh):
    m = _DummySum().shard(mesh)
    m.update(5.0)
    m.update(7.0)
    enc = encode_metric(m)
    fresh = _DummySum().shard(mesh)
    dec = decode_metric(enc.blob, enc.digests)
    assert not dec.failed
    before = obs.counter_value("sync.resharded_states", metric="_DummySum")
    fresh.merge_state(arrays_to_merge_state(fresh, dec.arrays), other_count=enc.update_count)
    assert obs.counter_value("sync.resharded_states", metric="_DummySum") > before
    assert fresh.state["x"].placements == (Partial("sum"),)  # merged leaves live on the mesh again
    assert float(fresh.compute()) == 12.0


def test_accuracy_codec_roundtrip_of_a_placed_metric(mesh):
    preds, target = torch.tensor([0, 1, 2, 1, 0, 2, 2, 1]), torch.tensor([0, 1, 1, 1, 0, 2, 0, 1])
    m = mt.Accuracy(num_classes=3, validate_args=False, device="cpu").shard(mesh)
    twin = mt.Accuracy(num_classes=3, validate_args=False, device="cpu")
    m.update(preds, target)
    twin.update(preds, target)
    want = m.compute()
    enc, enc_twin = encode_metric(m), encode_metric(twin)
    # the whole values are encoded: the blob and digests of an unplaced twin
    assert enc.blob == enc_twin.blob and enc.digests == enc_twin.digests
    fresh = mt.Accuracy(num_classes=3, validate_args=False, device="cpu").shard(mesh)
    dec = decode_metric(enc.blob, enc.digests)
    assert not dec.failed
    fresh._ckpt_load_extra_state(m._ckpt_extra_state())
    fresh.load_state_pytree(arrays_to_pytree(fresh, dec.arrays))
    assert_bitwise_equal(fresh.compute(), want)
    for value in fresh.state.values():
        assert isinstance(value, DTensor) and value.device_mesh == mesh


# ------------------------------------------------------------ the collectives


def test_mesh_backend_collectives_follow_the_dtensor_placement(mesh):
    bk = MeshBackend(mesh)
    v = torch.tensor([3.0, -1.0])
    part = DTensor.from_local(v, mesh, (Partial("sum"),), run_check=False)
    for fn in (bk.psum, bk.pmean, bk.pmax, bk.pmin):
        out = fn(part)
        assert out.placements == (Replicate(),)
        assert_bitwise_equal(out, v)
    whole = DTensor.from_local(v, mesh, (Replicate(),), run_check=False)
    assert bk.psum(whole) is whole  # already the value: an identity
    assert_bitwise_equal(bk.psum(v), v)  # plain in, plain out
    assert bk.pop_telemetry()["in_xla_reductions"] == 6
    assert not bk.pop_telemetry()


# ----------------------------------------------- core methods on a placed metric


def test_half_and_set_dtype_keep_the_placement(mesh):
    m = _DummySum().shard(mesh)
    m.update(torch.tensor(1.5))
    m.half()
    assert m.x.dtype == torch.bfloat16 and m.state["x"].placements == (Partial("sum"),)
    m.set_dtype(torch.float32)
    assert m.x.dtype == torch.float32 and float(m.compute()) == 1.5


def test_to_device_keeps_the_mesh_device_type(mesh):
    m = _DummySum().shard(mesh)
    m.update(2.0)
    m.to_device("cpu")
    assert m.state["x"].placements == (Partial("sum"),) and float(m.compute()) == 2.0
    m._placement = (type("CudaMesh", (), {"device_type": "cuda"})(), "batch")
    with pytest.raises(MetricsTPUUserError, match="placed on a cuda mesh"):
        m.to_device("cpu")


def test_state_dict_holds_the_whole_values(mesh):
    m = _DummySum().shard(mesh)
    m.update(2.5)
    sd = m.state_dict()
    assert type(sd["x"]) is torch.Tensor and float(sd["x"]) == 2.5
    again = _DummySum().shard(mesh)
    again.load_state_dict(sd)
    assert again.state["x"].placements == (Partial("sum"),) and float(again.compute()) == 2.5


def test_sync_async_on_a_placed_metric(mesh):
    # the mesh backend runs no background rounds (no packing, no delta) ...
    m = _CatM().shard(mesh)
    m.update(torch.tensor([1.0, 2.0]))
    assert m.sync_async() is None
    # ... a placed metric on an eager backend does, bitwise the synchronous twin
    a = _CatM(sync_backend=LoopbackBackend()).shard(mesh, install_backend=False)
    b = _CatM(sync_backend=LoopbackBackend())
    for x in (torch.tensor([1.0, 2.0]), torch.tensor([0.125, -3.0])):
        a.update(x)
        b.update(x)
        handle = a.sync_async()
        assert handle is not None
        handle.wait()
    assert_bitwise_equal(a.compute(), b.compute())
    assert a.last_sync_report["backend"] == "LoopbackBackend"


def test_pickling_drops_the_placement_and_keeps_the_local_values(mesh):
    m = _DummySum().shard(mesh)
    m.update(4.0)
    clone = pickle.loads(pickle.dumps(m))
    assert clone._placement is None and clone.sync_backend is None
    assert type(clone.x) is torch.Tensor and float(clone.x) == 4.0
    clone.shard(mesh)
    assert clone.state["x"].placements == (Partial("sum"),) and float(clone.compute()) == 4.0


def test_forward_and_update_batched_on_a_placed_metric(mesh):
    m = mt.Accuracy(num_classes=3, device="cpu").shard(mesh)
    twin = mt.Accuracy(num_classes=3, device="cpu")
    preds, target = torch.tensor([0, 1, 2, 1]), torch.tensor([0, 1, 1, 1])
    assert_bitwise_equal(m(preds, target), twin(preds, target))  # the batch's value
    m.update_batched(torch.stack([preds, target]), torch.stack([target, target]))
    twin.update_batched(torch.stack([preds, target]), torch.stack([target, target]))
    assert m.state["tp"].placements == (Partial("sum"),)
    assert_bitwise_equal(m.compute(), twin.compute())


def test_a_placed_window_rotates_its_ring(mesh):
    w = mt.WindowedMetric(mt.SumMetric(device="cpu"), window_size=2, device="cpu").shard(mesh)
    for x in (1.0, 2.0):
        w.update(torch.tensor(x))
        w.advance()
    w.update(torch.tensor(4.0))
    assert float(w.compute()) == 6.0  # the bucket of 1.0 was evicted


def test_a_dtensor_batch_counts_its_local_rows(mesh):
    m = _SumM().shard(mesh)
    rows = DTensor.from_local(torch.tensor([1.0, 2.0, 3.0]), mesh, row_sharded(mesh), run_check=False)
    m.update(rows)
    assert float(m.compute()) == 6.0
    whole = DTensor.from_local(torch.tensor([1.0]), mesh, replicated(mesh), run_check=False)
    with pytest.raises(MetricsTPUUserError, match="Shard"):
        m.update(whole)


def test_collection_shard_keeps_compute_groups_aliased(mesh):
    col = mt.MetricCollection(
        {"p": mt.Precision(num_classes=3, average="macro", device="cpu"),
         "r": mt.Recall(num_classes=3, average="macro", device="cpu")},
        device="cpu",
    )
    preds, target = torch.tensor([0, 1, 2, 1]), torch.tensor([0, 1, 1, 1])
    col.update(preds, target)
    col.shard(mesh)
    assert col.compute_groups == {0: ["p", "r"]}
    assert col["p"].tp is col["r"].tp and col["p"].state["tp"].placements == (Partial("sum"),)
    col.update(preds, target)
    twin = mt.MetricCollection(
        {"p": mt.Precision(num_classes=3, average="macro", device="cpu"),
         "r": mt.Recall(num_classes=3, average="macro", device="cpu")},
        device="cpu",
    )
    twin.update(preds, target)
    twin.update(preds, target)
    got, want = col.compute(), twin.compute()
    for key in want:
        assert_bitwise_equal(got[key], want[key])


def test_shard_streams_rejects_an_indivisible_count_and_installs_no_backend(mesh):
    m = mt.MultiStreamMetric(mt.Accuracy(num_classes=4, device="cpu"), num_streams=10, device="cpu")
    placed = mt.multistream.shard_streams(m, mt.multistream.stream_mesh(device="cpu"))
    assert placed.sync_backend is None and placed.state["stream_rows"].placements == (Partial("sum"),)
    assert mt.multistream.stream_sharding(mesh) == (Shard(0),)
    assert mt.multistream.replicate_sharding(mesh) == (Replicate(),)
    with pytest.raises(ValueError, match="divide"):
        mt.multistream.shard_streams(m, _FakeMesh(3))


class _FakeMesh:
    """A mesh of ``n`` ranks on one axis, for the divisibility check alone."""

    mesh_dim_names = ("batch",)
    ndim = 1

    def __init__(self, n):
        self.n = n

    def size(self, dim=None):
        return self.n


def test_obs_counters_reach_the_summary_and_the_prometheus_text(mesh):
    obs.reset()
    m = _DummySum().shard(mesh)
    m.update(1.0)
    m.compute()
    m.load_state_pytree(m.state_pytree())
    sync = obs.summarize_counters()["sync"]
    assert sync["mesh_placements"] == 1 and sync["resharded_states"] == 1 and sync["in_xla_reductions"] >= 1
    parsed = parse_prometheus_text(prometheus_text())
    names = {name for name, _labels in parsed}
    assert {"metrics_tpu_sync_mesh_placements_total", "metrics_tpu_sync_resharded_states_total",
            "metrics_tpu_sync_in_xla_reductions_total"} <= names, sorted(names)
