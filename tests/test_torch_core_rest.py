"""The rest of the ``Metric`` core against the JAX package.

* ``compute_on_cpu``: list and buffer states sit in host memory after every
  update and ``forward`` (on the CPU here, so the checks are of the buffer
  bookkeeping: appends go on in place into the host buffer), values equal
  the JAX package's ``compute_on_cpu=True`` run.
* ``compute_with_cache``: ``True`` returns the cached value until the next
  update, ``False`` recomputes on every call, as the JAX package does.
* ``to_device``: states and defaults move, buffer row counts stay host ints,
  and the metric goes on updating there.
* ``state``: the same names, kinds and values as the JAX package's.
* ``MetricCollection.advance_windows``: leaders only, then the group states
  are shared again; the evicted counts and values equal the JAX package's
  and those of the members advanced one by one.

Integers compare exactly, floats to ``rtol=1e-6`` (float32 on both sides,
summed in another order by torch and XLA).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import metrics_tpu as jm
import metrics_tpu_torch as mt

EAGER = {"jit_update": False, "jit_compute": False}


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def assert_same(port, ref):
    port, ref = _np(port), np.asarray(ref)
    assert port.dtype == ref.dtype and port.shape == ref.shape
    if np.issubdtype(ref.dtype, np.floating):
        np.testing.assert_allclose(port, ref, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(port, ref)


def _probs(seed, n=24, c=3):
    rng = np.random.default_rng(seed)
    p = rng.random((n, c)).astype(np.float32)
    return p / p.sum(1, keepdims=True), rng.integers(0, c, n)


class CountingSum(mt.Metric):
    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("x", torch.tensor(0.0), dist_reduce_fx="sum")
        self.computes = 0

    def update(self, x):
        self.x = self.x + torch.as_tensor(x, dtype=torch.float32)

    def compute(self):
        self.computes += 1
        return self.x


class ListMetric(mt.Metric):
    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("x", [], dist_reduce_fx="cat")

    def update(self, x):
        self.x.append(torch.as_tensor(x, dtype=torch.float32))

    def compute(self):
        return torch.cat(self.x)


# ---------------------------------------------------------- compute_on_cpu
def test_compute_on_cpu_list_state():
    m = ListMetric(compute_on_cpu=True)
    m.update(torch.tensor([1.0, 2.0]))
    m.update(torch.tensor([3.0]))
    assert m.compute_on_cpu and all(v.device.type == "cpu" for v in m.x)
    np.testing.assert_array_equal(m.compute().numpy(), [1.0, 2.0, 3.0])


@pytest.mark.parametrize("via", ["update", "forward"])
def test_compute_on_cpu_buffer_state_matches_jax(via):
    port = mt.AUROC(num_classes=3, compute_on_cpu=True, device="cpu")
    ref = jm.AUROC(num_classes=3, compute_on_cpu=True, **EAGER)
    twin = mt.AUROC(num_classes=3, device="cpu")
    bufs = []
    for seed in range(4):
        p, t = _probs(seed)
        getattr(port, via)(torch.from_numpy(p), torch.from_numpy(t))
        getattr(ref, via)(jnp.asarray(p), jnp.asarray(t))
        twin.update(torch.from_numpy(p), torch.from_numpy(t))
        bufs.append(port.preds__buf)
        assert port.preds__buf.device.type == "cpu" and isinstance(port.preds__len, int)
    if via == "update":
        # the host buffer is appended in place until it must grow (capacity 256 rows)
        assert all(b is bufs[0] for b in bufs)
    assert port.preds__len == ref.preds__len == 96
    assert_same(port.compute(), ref.compute())
    assert torch.equal(port.compute(), twin.compute())


# ------------------------------------------------------ compute_with_cache
@pytest.mark.parametrize("cache", [True, False])
def test_compute_with_cache(cache):
    m = CountingSum(compute_with_cache=cache)
    m.update(2.0)
    values = [float(m.compute()) for _ in range(3)]
    assert values == [2.0, 2.0, 2.0]
    assert m.computes == (1 if cache else 3)
    m.update(1.0)
    assert float(m.compute()) == 3.0
    assert m.computes == (2 if cache else 4)

    class JaxCounting(jm.SumMetric):
        computes = 0

        def compute(self):
            type(self).computes += 1
            return super().compute()

    ref = JaxCounting(compute_with_cache=cache, **EAGER)
    ref.update(2.0)
    for _ in range(3):
        ref.compute()
    assert JaxCounting.computes == (1 if cache else 3)


# -------------------------------------------------------------- to_device
def test_to_device_keeps_counts_on_the_host():
    m = mt.AUROC(num_classes=3, device="cpu")
    p, t = _probs(0)
    m.update(torch.from_numpy(p), torch.from_numpy(t))
    before = m.compute()
    assert m.to_device("cpu") is m
    assert m.device == torch.device("cpu") and isinstance(m.preds__len, int)
    m.update(torch.from_numpy(p), torch.from_numpy(t))
    assert m.preds__len == 48
    ref = jm.AUROC(num_classes=3, **EAGER)
    ref.update(jnp.asarray(p), jnp.asarray(t))
    assert_same(before, ref.compute())
    ref.to_device(jax.devices("cpu")[0])
    assert isinstance(ref.state["preds__len"], int)


def test_to_device_refuses_an_absent_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the move is held by tests/test_torch_cuda.py")
    m = mt.SumMetric(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        m.to_device("cuda")
    assert m.device == torch.device("cpu")


# ------------------------------------------------------------------ state
@pytest.mark.parametrize("name", ["AUROC", "Accuracy", "CatMetric", "StreamingQuantile"])
def test_state_matches_jax(name):
    kwargs = {"AUROC": {"num_classes": 3}, "Accuracy": {"num_classes": 3},
              "CatMetric": {}, "StreamingQuantile": {"capacity": 8, "max_items": 1 << 9}}[name]
    port = getattr(mt, name)(device="cpu", **kwargs)
    ref = getattr(jm, name)(**EAGER, **kwargs)
    for seed in range(2):
        p, t = _probs(seed)
        args = (p, t) if name in ("AUROC", "Accuracy") else (p[:, 0],)
        port.update(*(torch.from_numpy(a) for a in args))
        ref.update(*(jnp.asarray(a) for a in args))
    got, want = port.state, ref.state
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if isinstance(value, int):
            assert got[key] == value
        elif isinstance(value, list):
            assert len(got[key]) == len(value)
            for a, b in zip(got[key], value):
                assert_same(a, b)
        else:
            assert_same(got[key], value)


# --------------------------------------------------------- advance_windows
def _window_collection(pkg, **kw):
    return pkg.MetricCollection(
        {
            "win": pkg.WindowedMetric(pkg.MeanMetric(**kw), window_size=2, **kw),
            "acc": pkg.Accuracy(num_classes=2, **kw),
        },
        **({"device": "cpu"} if "device" in kw else {}),
    )


def test_advance_windows_rotates_members_like_jax():
    port, ref = _window_collection(mt, device="cpu"), _window_collection(jm, **EAGER)
    seen = []
    for col, make in ((port, torch.tensor), (ref, jnp.asarray)):
        trace = []
        col["win"].update(make(2.0))
        trace.append(col.advance_windows())
        col["win"].update(make(4.0))
        trace.append(float(col["win"].compute()))
        trace.append(col.advance_windows())
        col["win"].update(make(6.0))
        trace.append(float(col["win"].compute()))
        seen.append(trace)
    assert seen[0] == seen[1] == [{"win": 0}, 3.0, {"win": 1}, 5.0]


def test_advance_windows_advances_group_leaders_only():
    """Two windows of one base share a compute group: one advance of the
    leader, shared again, equals advancing two separate windows once each."""
    def members(pkg, **kw):
        return {
            "w1": pkg.WindowedMetric(pkg.SumMetric(**kw), window_size=3, **kw),
            "w2": pkg.WindowedMetric(pkg.SumMetric(**kw), window_size=3, **kw),
        }

    rng = np.random.default_rng(4)
    batches = [(rng.random(8) * 8).round().astype(np.float32) / 8 for _ in range(7)]  # eighths: exact sums
    col = mt.MetricCollection(members(mt, device="cpu"), device="cpu")
    ref = jm.MetricCollection(members(jm, **EAGER))
    alone = members(mt, device="cpu")
    trace, ref_trace, alone_trace = [], [], []
    for i, b in enumerate(batches):
        col.update(torch.from_numpy(b))
        ref.update(jnp.asarray(b))
        for m in alone.values():
            m.update(torch.from_numpy(b))
        if i % 2 == 1:
            trace.append(col.advance_windows())
            ref_trace.append(ref.advance_windows())
            alone_trace.append({k: m.advance() for k, m in alone.items()})
        trace.append({k: float(v) for k, v in col.compute().items()})
        ref_trace.append({k: float(v) for k, v in ref.compute().items()})
        alone_trace.append({k: float(m.compute()) for k, m in alone.items()})
    assert col.compute_groups == {0: ["w1", "w2"]}
    # the group's leader alone advanced, so the evicted counts name it only
    assert trace[1] == {"w1": 0} and trace == ref_trace
    values = [t for t in trace if "w2" in t]
    assert values == [t for t in alone_trace if "w2" in t and isinstance(t["w2"], float)]
    assert col["w2"].w__ptr is col["w1"].w__ptr  # shared again after the advance
