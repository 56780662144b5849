"""The port's windowed and time-decayed wrappers against the JAX package.

Inputs are made from a seed with numpy and fed to both packages.  Tolerances:

* bitwise: every ring (window counts, the pointer, integer states, float
  states fed with multiples of 1/8, whose sums are exact, and every sketch
  leaf), ``advance``'s eviction counts, ``window_counts``, the windowed
  values, the tracker's carried rings, and a JAX state loaded mid-stream
  that then continues;
* ``EMA_RTOL`` relative for ``TimeDecayedMetric``: XLA fuses each
  ``ema * d + value`` into one multiply-add, PyTorch rounds twice.
"""

import pickle

import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu_torch as mt
from metrics_tpu_torch.interop import load_jax_state
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

EMA_RTOL = 4 * 2.0**-24
C = 5


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _same(a, b, key=""):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (key, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), (key, a, b)


def _same_states(jmetric, pmetric):
    jtree = {k: v for k, v in jmetric.state_pytree().items() if k != "_update_count"}
    ptree = {k: v for k, v in pmetric.state_pytree().items() if k != "_update_count"}
    assert sorted(jtree) == sorted(ptree)
    for k in jtree:
        _same(jtree[k], ptree[k], k)


def _classification(rng, n=24):
    probs = rng.random((n, C)).astype(np.float32)
    return probs / probs.sum(1, keepdims=True), rng.integers(0, C, n)


def _eighths(rng, n=24):
    return (rng.integers(-16, 17, n) / 8).astype(np.float32), (rng.integers(-16, 17, n) / 8).astype(np.float32)


def _values(rng, n=40):
    v = np.round(rng.normal(size=n), 1).astype(np.float32)
    v[::11] = -0.0
    return v


def _torch(args):
    return tuple(torch.from_numpy(np.asarray(a)) for a in args)


CASES = {
    "accuracy": (lambda lib, **kw: lib.Accuracy(num_classes=C, **kw), _classification),
    "mse": (lambda lib, **kw: lib.MeanSquaredError(**kw), _eighths),
    "quantile": (lambda lib, **kw: lib.StreamingQuantile(q=(0.25, 0.5, 0.9), capacity=8, max_items=1 << 9, **kw),
                 lambda rng: (_values(rng),)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_windowed_metric_rings_and_values_bitwise(case):
    make, batch = CASES[case]
    jw = jm.WindowedMetric(make(jm), window_size=3)
    pw = mt.WindowedMetric(make(mt, device="cpu"), window_size=3, device="cpu")
    rng = np.random.default_rng(1)
    for step in range(8):
        args = batch(rng)
        jw.update(*args)
        pw.update(*_torch(args))
        if step % 2:
            assert jw.advance() == pw.advance()
        _same_states(jw, pw)
        assert np.array_equal(jw.window_counts(), pw.window_counts())
        _same(jw.compute(), pw.compute(), f"step {step}")
    args = batch(rng)
    _same(jw(*args), pw(*_torch(args)), "forward")
    _same_states(jw, pw)
    clone = pickle.loads(pickle.dumps(pw))
    _same(clone.compute(), pw.compute(), "pickle")
    pw.reset()
    jw.reset()
    _same_states(jw, pw)


def test_window_update_never_reads_the_pointer_on_the_host(monkeypatch):
    pw = mt.WindowedMetric(mt.MeanSquaredError(device="cpu"), window_size=4, device="cpu")
    pw.advance()

    def refuse(*_):
        raise AssertionError("the ring write read the pointer on the host")

    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "__int__", refuse)
    monkeypatch.setattr(torch.Tensor, "__index__", refuse)
    pw.update(torch.ones(3), torch.zeros(3))
    monkeypatch.undo()
    assert pw.window_counts().tolist() == [0, 0, 0, 1]


class _Gathered(mt.Metric):
    """A fixed-shape tensor state without an elementwise bucket merge."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("rows", torch.zeros(3), dist_reduce_fx="cat")

    def update(self, x):
        self.rows = x

    def compute(self):
        return self.rows


def test_windowed_metric_rejects_growing_or_unmergeable_states():
    with pytest.raises(MetricsTPUUserError, match="fixed-shape"):
        mt.WindowedMetric(mt.CatMetric(device="cpu"), window_size=2, device="cpu")
    with pytest.raises(MetricsTPUUserError, match="window_size"):
        mt.WindowedMetric(mt.SumMetric(device="cpu"), window_size=0, device="cpu")
    with pytest.raises(MetricsTPUUserError, match="Metric instance"):
        mt.WindowedMetric(object(), window_size=2, device="cpu")
    with pytest.raises(MetricsTPUUserError, match="dist_reduce_fx"):
        mt.WindowedMetric(_Gathered(device="cpu"), window_size=2, device="cpu")
    with pytest.raises(MetricsTPUUserError, match="half_life"):
        mt.TimeDecayedMetric(mt.SumMetric(device="cpu"), half_life=0.0, device="cpu")


def test_time_decayed_metric_within_ema_tolerance():
    jt = jm.TimeDecayedMetric(jm.MeanSquaredError(), half_life=3.0)
    pt = mt.TimeDecayedMetric(mt.MeanSquaredError(device="cpu"), half_life=3.0, device="cpu")
    rng = np.random.default_rng(2)
    for _ in range(12):
        p = rng.normal(size=32).astype(np.float32)
        t = rng.normal(size=32).astype(np.float32)
        jt.update(p, t)
        pt.update(torch.from_numpy(p), torch.from_numpy(t))
    np.testing.assert_allclose(_np(pt.ema_num), np.asarray(jt.ema_num), rtol=EMA_RTOL, atol=0)
    np.testing.assert_allclose(_np(pt.ema_den), np.asarray(jt.ema_den), rtol=EMA_RTOL, atol=0)
    np.testing.assert_allclose(_np(pt.compute()), np.asarray(jt.compute()), rtol=2 * EMA_RTOL, atol=0)
    jv = jm.TimeDecayedMetric(jm.Accuracy(num_classes=C, average=None), half_life=2.0)
    pv = mt.TimeDecayedMetric(mt.Accuracy(num_classes=C, average=None, device="cpu"), half_life=2.0, device="cpu")
    for _ in range(3):
        args = _classification(rng)
        jv.update(*args)
        pv.update(*_torch(args))
    np.testing.assert_allclose(_np(pv.compute()), np.asarray(jv.compute()), rtol=2 * EMA_RTOL, atol=0)


def test_tracker_carries_the_ring_into_each_step():
    jtr = jm.MetricTracker(jm.MetricCollection({
        "w": jm.WindowedMetric(jm.Accuracy(num_classes=C), window_size=2), "acc": jm.Accuracy(num_classes=C)}))
    ptr = mt.MetricTracker(mt.MetricCollection({
        "w": mt.WindowedMetric(mt.Accuracy(num_classes=C, device="cpu"), window_size=2, device="cpu"),
        "acc": mt.Accuracy(num_classes=C, device="cpu")}, device="cpu"))
    rng = np.random.default_rng(3)
    for epoch in range(3):
        jtr.increment()
        ptr.increment()
        for _ in range(2):
            args = _classification(rng)
            jtr.update(*args)
            ptr.update(*_torch(args))
        jtr[-1]["w"].advance()
        ptr[-1]["w"].advance()
        _same_states(jtr[-1]["w"], ptr[-1]["w"])
    jall, pall = jtr.compute_all(), ptr.compute_all()
    for k in jall:
        _same(jall[k], pall[k], k)
    # the steps hold copies: advancing the newest ring leaves the last step's alone
    before = ptr[-2]["w"].w__count.clone()
    ptr[-1]["w"].advance()
    assert torch.equal(ptr[-2]["w"].w__count, before)


def test_load_jax_state_mid_stream_continues_bitwise():
    rng = np.random.default_rng(4)
    jq = jm.StreamingQuantile(q=0.5, capacity=8, max_items=1 << 9)
    jw = jm.WindowedMetric(jm.StreamingQuantile(q=0.9, capacity=8, max_items=1 << 9), window_size=3)
    for step in range(3):
        v = _values(rng)
        jq.update(v)
        jw.update(v)
        jw.advance()
    pq = mt.StreamingQuantile(q=0.5, capacity=8, max_items=1 << 9, device="cpu")
    pw = mt.WindowedMetric(mt.StreamingQuantile(q=0.9, capacity=8, max_items=1 << 9, device="cpu"),
                           window_size=3, device="cpu")
    load_jax_state(pq, jq.state_pytree())
    load_jax_state(pw, jw.state_pytree())
    assert pq.sketch_tree("sketch")["key"].dtype == torch.uint32
    for step in range(3):
        v = _values(rng)
        jq.update(v)
        pq.update(torch.from_numpy(v))
        jw.update(v)
        pw.update(torch.from_numpy(v))
        _same_states(jq, pq)
        _same_states(jw, pw)
    _same(jq.compute(), pq.compute())
    _same(jw.compute(), pw.compute())
    with pytest.raises(ValueError, match="uint32"):
        load_jax_state(pq, {**jq.state_pytree(), "sketch__sk_key": np.zeros(2, np.int32)})
