"""The port's sketches and sketch metrics against the JAX package.

Inputs are made from a seed with numpy and fed to both packages, at small
sizes (capacity 8, 10 or 16; ``max_items`` at most ``2**12``) so that
compactions fire at several levels.  Tolerances:

* bitwise: the threefry draws (split, fold_in, randint bits, uniform), every
  KLL leaf (``buf``, ``cnt``, ``key``, ``n``, ``nc``) after updates, merges
  and ``forward``, the quantiles, CDFs and total weights (all below ``2**24``
  total weight, where every float32 partial sum is exact), reservoir states
  with unit weights, the histogram's edges and counts, and the schema
  digests;
* ``RESERVOIR_RTOL`` relative on the reservoir keys ``u ** (1/w)`` with other
  weights: XLA's and PyTorch's ``pow`` may differ in the last bit.
"""

import pickle
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu_torch as mt
from metrics_tpu.streaming import sketches as jsk
from metrics_tpu_torch.ops import kll as kll_ops
from metrics_tpu_torch.parallel import LoopbackBackend
from metrics_tpu_torch.streaming import _threefry
from metrics_tpu_torch.streaming import sketches as psk

RESERVOIR_RTOL = 2.0**-23
CASES = [(8, 1 << 9), (10, 1 << 10), (16, 1 << 12)]  # (capacity, max_items)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _same(a, b, key=""):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (key, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), (key, a, b)


def _same_tree(jtree, ptree, tag=""):
    assert sorted(jtree) == sorted(ptree), tag
    for k in jtree:
        _same(jtree[k], ptree[k], f"{tag}:{k}")


def _stream(seed: int, size: int) -> np.ndarray:
    """Values with ties, both signed zeros, NaN and both infinities."""
    rng = np.random.default_rng(seed)
    v = np.round(rng.normal(size=size), 1).astype(np.float32)
    v[::13] = 0.0
    v[5::17] = -0.0
    if size > 10:
        v[[3, 7, 9]] = [np.nan, np.inf, -np.inf]
    return v


# ---------------------------------------------------------------------- threefry
def test_jax_draws_with_the_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", [0, 5, 2**31 - 1, -1, 2**32 + 3])
def test_seed_is_prng_key(seed):
    _same(jax.random.PRNGKey(seed), _threefry.seed(seed))


def test_split_randint_uniform_and_fold_in_bitwise():
    key, tkey = jax.random.PRNGKey(11), _threefry.seed(11)
    for _ in range(6):
        key, sub = jax.random.split(key)
        tnew, tsub = _threefry.split(tkey)
        _same(key, _threefry.as_uint32(tnew))
        _same(sub, _threefry.as_uint32(tsub))
        _same(jax.random.randint(sub, (23,), 0, 2, dtype=jnp.int32), _threefry.randint_bits(tsub, 23))
        _same(jax.random.uniform(sub, (257,), minval=1e-7, maxval=1.0), _threefry.uniform(tsub, 257, 1e-7, 1.0))
        tkey = _threefry.as_uint32(tnew)
    for data in (0, 5, 2**32 - 1):
        _same(jax.random.fold_in(key, data), _threefry.as_uint32(_threefry.fold_in(tkey, data)))


def test_batched_split_and_bits():
    keys = jnp.stack([jax.random.PRNGKey(i) for i in range(5)])
    pairs = jax.vmap(jax.random.split)(keys)
    tnew, tsub = _threefry.split(torch.from_numpy(np.asarray(keys).astype(np.int64)))
    _same(pairs[:, 0], _threefry.as_uint32(tnew))
    _same(pairs[:, 1], _threefry.as_uint32(tsub))
    bits = jax.vmap(lambda k: jax.random.randint(k, (9,), 0, 2, dtype=jnp.int32))(pairs[:, 1])
    _same(bits, _threefry.randint_bits(tsub, 9))


def _rounded32(exact: Fraction) -> np.float32:
    """``exact`` rounded once to float32 (to nearest, ties to even)."""
    guess = np.float32(float(exact))
    cands = [np.nextafter(guess, np.float32(-np.inf)), guess, np.nextafter(guess, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - exact), int(c.view(np.uint32)) & 1))


def test_fma32_rounds_once():
    rng = np.random.default_rng(0)
    a, b = (rng.normal(size=2000).astype(np.float32) for _ in range(2))
    c = (rng.normal(size=2000) * np.exp2(rng.integers(-30, 30, 2000))).astype(np.float32)
    got = _threefry.fma32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = [_rounded32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))) for x, y, z in zip(a, b, c)]
    assert got.tobytes() == np.array(want, np.float32).tobytes()


# ---------------------------------------------------------------------- KLL
# jitted once: each compiles per state shape and value count, and the JAX
# package's merge of two states unrolls a scan per level (its eager form
# compiles them anew at every call)
_jax_update = jax.jit(jsk.kll_update)
_jax_merge2 = jax.jit(lambda a, b: jsk.kll_merge([a, b]))
_jax_quantile = jax.jit(jsk.kll_quantile)
_jax_cdf = jax.jit(jsk.kll_cdf)


@pytest.mark.parametrize("capacity,max_items", CASES)
def test_kll_update_merge_and_estimates_bitwise(capacity, max_items):
    jst = jsk.kll_init(capacity, seed=3, max_items=max_items)
    pst = psk.kll_init(capacity, seed=3, max_items=max_items, device="cpu")
    _same_tree(jst, pst, "init")
    for step, size in enumerate((701, 2, 701, 701)):
        v = _stream(step, size)
        jst, pst = _jax_update(jst, v), psk.kll_update(pst, torch.from_numpy(v))
        _same_tree(jst, pst, f"update {step}")
    assert int(pst["nc"]) > 0 and int(pst["cnt"][2:].sum()) > 0  # compactions reached level 2 and up
    other_v = _stream(9, 701)
    jo = _jax_update(jsk.kll_init(capacity, seed=9, max_items=max_items), other_v)
    po = psk.kll_update(psk.kll_init(capacity, seed=9, max_items=max_items, device="cpu"), torch.from_numpy(other_v))
    je = jsk.kll_init(capacity, seed=1, max_items=max_items)
    pe = psk.kll_init(capacity, seed=1, max_items=max_items, device="cpu")
    # the JAX package merges a list two states at a time, in order; the port folds it in one pass
    jm_ = _jax_merge2(_jax_merge2(_jax_merge2(jst, je), jo), jo)
    pm_ = psk.kll_merge([pst, pe, po, po])
    _same_tree(jm_, pm_, "merge")
    _same_tree(_jax_merge2(je, jst), psk.kll_merge([pe, pst]), "merge into empty")
    _same_tree(_jax_merge2(je, je), psk.kll_merge([pe, pe]), "merge of empties")
    qs = np.array([0.0, 0.01, 0.25, 0.5, 0.9, 0.999, 1.0], np.float32)
    _same(_jax_quantile(jm_, qs), psk.kll_quantile(pm_, torch.from_numpy(qs)))
    _same(_jax_quantile(jm_, 0.5), psk.kll_quantile(pm_, 0.5))
    xs = np.linspace(-3, 3, 13).astype(np.float32)
    _same(_jax_cdf(jm_, xs), psk.kll_cdf(pm_, torch.from_numpy(xs)))
    _same(_jax_cdf(jm_, 0.0), psk.kll_cdf(pm_, 0.0))
    _same(jsk.kll_total_weight(jm_), psk.kll_total_weight(pm_))
    _same(_jax_quantile(je, 0.5), psk.kll_quantile(pe, 0.5))  # empty: NaN
    _same(_jax_cdf(je, xs), psk.kll_cdf(pe, torch.from_numpy(xs)))


def test_kll_merge_of_many_is_the_jax_chain():
    states = [jsk.kll_init(8, seed=i, max_items=1 << 9) for i in range(3)]
    states = [_jax_update(s, _stream(30 + i, 701)) for i, s in enumerate(states)]
    ported = [{k: torch.from_numpy(np.array(v)) for k, v in s.items()} for s in states]
    _same_tree(jsk.kll_merge(states[:1]), psk.kll_merge(ported[:1]), "one state")
    _same_tree(_jax_merge2(_jax_merge2(states[0], states[1]), states[2]), psk.kll_merge(ported), "three states")


def test_kll_all_padding_chunks_still_advance_the_key():
    # whole chunks of NaN are all padding: the key advances, nothing folds
    v = np.full(4 * 6, np.nan, np.float32)
    v[:3] = [1.0, -0.0, 0.0]
    jst, pst = jsk.kll_init(8, max_items=1 << 9), psk.kll_init(8, max_items=1 << 9, device="cpu")
    for _ in range(3):
        jst, pst = _jax_update(jst, v), psk.kll_update(pst, torch.from_numpy(v))
    _same_tree(jst, pst)
    assert int(pst["n"]) == 9
    _same_tree(jst, psk.kll_update(pst, torch.zeros((0,))), "empty update")


def test_kll_batched_update_and_merge_match_vmap():
    capacity, max_items, sketches = 8, 1 << 9, 3
    jinit = jax.vmap(lambda s: jsk.kll_init(capacity, max_items=max_items) | {"key": s})(
        jnp.stack([jax.random.PRNGKey(i) for i in range(sketches)]))
    pinit = {k: torch.from_numpy(np.array(v)) for k, v in jinit.items()}
    vals = np.stack([_stream(i, 301) for i in range(sketches)])
    jst = jax.jit(jax.vmap(jsk.kll_update))(jinit, vals)
    pst = psk.kll_update(pinit, torch.from_numpy(vals))
    _same_tree(jst, pst, "batched update")
    jmerged = jax.jit(jax.vmap(lambda a, b: jsk.kll_merge([a, b])))(jst, jinit)
    _same_tree(jmerged, psk.kll_merge([pst, pinit]), "batched merge")


def test_kll_rank_error_bound_and_arguments():
    for n, cap in [(0, 8), (5, 8), (8, 8), (9, 8), (10**6, 256), (10**9, 2048)]:
        assert jsk.kll_rank_error_bound(n, cap) == psk.kll_rank_error_bound(n, cap)
    with pytest.raises(ValueError, match="even integer"):
        psk.kll_init(7, device="cpu")
    with pytest.raises(ValueError, match=str(kll_ops.MAX_CAPACITY)):
        kll_ops.check_capacity(kll_ops.MAX_CAPACITY + 2, torch.device("cuda"))
    kll_ops.check_capacity(kll_ops.MAX_CAPACITY + 2, torch.device("cpu"))
    st = psk.kll_init(8, device="cpu")
    with pytest.raises(ValueError, match="chunks must be"):
        kll_ops.kll_fold(st["buf"][None], st["cnt"][None], st["key"][None], st["nc"][None],
                         torch.zeros((1, 2, 4)), torch.zeros((1, 2), dtype=torch.int32), torch.zeros((3,), dtype=torch.int32))
    with pytest.raises(ValueError, match="key must be"):
        kll_ops.kll_fold(st["buf"][None], st["cnt"][None], st["key"][None].to(torch.int64), st["nc"][None],
                         torch.zeros((1, 2, 4)), torch.zeros((1, 2), dtype=torch.int32), torch.zeros((2,), dtype=torch.int32))


def test_kll_fold_plain_is_the_cpu_path():
    st = psk.kll_init(8, max_items=1 << 9, device="cpu")
    before = kll_ops.kll_fold.launches
    a = psk.kll_update(st, torch.from_numpy(_stream(1, 97)))
    assert kll_ops.kll_fold.launches == before  # a CPU state never launches
    raw = torch.from_numpy(_stream(1, 100))
    chunks = torch.sort(torch.where(torch.isfinite(raw), raw, float("inf")).reshape(1, 25, 4), -1).values
    b = {k: v.clone() for k, v in st.items()}
    kll_ops.kll_fold_plain(b["buf"][None], b["cnt"][None], b["key"][None], b["nc"].reshape(1),
                           chunks, torch.isfinite(chunks).sum(-1, dtype=torch.int32), torch.zeros((25,), dtype=torch.int32))
    assert int(a["nc"]) > 0 and int(b["nc"]) > 0


# ---------------------------------------------------------------------- reservoir
@pytest.mark.parametrize("distinct", [True, False])
def test_reservoir_unit_weights_bitwise(distinct):
    jst = jsk.reservoir_init(16, seed=2, distinct=distinct)
    pst = psk.reservoir_init(16, seed=2, distinct=distinct, device="cpu")
    _same_tree(jst, pst, "init")
    for step in range(4):
        v = _stream(step, 37)
        jst, pst = jsk.reservoir_update(jst, v), psk.reservoir_update(pst, torch.from_numpy(v))
        _same_tree(jst, pst, f"update {step}")
    jo = jsk.reservoir_update(jsk.reservoir_init(16, seed=7), _stream(8, 20))
    po = psk.reservoir_update(psk.reservoir_init(16, seed=7, device="cpu"), torch.from_numpy(_stream(8, 20)))
    _same_tree(jsk.reservoir_merge([jst, jo]), psk.reservoir_merge([pst, po]), "merge")
    jv, jmask = jsk.reservoir_values(jst)
    pv, pmask = psk.reservoir_values(pst)
    _same(jv, pv)
    _same(jmask, pmask)


def test_reservoir_weights_within_pow_tolerance():
    rng = np.random.default_rng(4)
    v = rng.normal(size=64).astype(np.float32)
    w = rng.uniform(0.05, 4.0, size=64).astype(np.float32)
    w[[1, 2, 3]] = [0.0, -1.0, np.nan]
    jst = jsk.reservoir_update(jsk.reservoir_init(24, seed=1), v, w)
    pst = psk.reservoir_update(psk.reservoir_init(24, seed=1, device="cpu"), torch.from_numpy(v), torch.from_numpy(w))
    np.testing.assert_allclose(_np(pst["rkeys"]), np.asarray(jst["rkeys"]), rtol=RESERVOIR_RTOL, atol=0)
    _same(jst["rkey"], pst["rkey"])
    _same(jst["rseen"], pst["rseen"])
    assert sorted(_np(pst["rvals"]).tolist()) == sorted(np.asarray(jst["rvals"]).tolist())


def test_bootstrap_resample_indices_is_the_wrappers_copy():
    from metrics_tpu_torch.wrappers._resample import bootstrap_resample_indices

    assert psk.bootstrap_resample_indices is bootstrap_resample_indices


# ---------------------------------------------------------------------- metrics
def _pair(cls, **kw):
    return getattr(jm, cls)(**kw), getattr(mt, cls)(device="cpu", **kw)


def _leaves(jmetric, pmetric, tag=""):
    _same_tree(jmetric.sketch_tree("sketch"), pmetric.sketch_tree("sketch"), tag)


def test_streaming_quantile_update_forward_compute_bitwise():
    jq, pq = _pair("StreamingQuantile", q=(0.1, 0.5, 0.99), capacity=8, max_items=1 << 10)
    for step, size in enumerate((50, 50, 173)):
        v = _stream(step, size)
        _same(jq(v), pq(torch.from_numpy(v)), f"forward {step}")
        _leaves(jq, pq, f"forward {step}")
    for step in range(2):
        v = _stream(10 + step, 91)
        jq.update(v)
        pq.update(torch.from_numpy(v))
    _leaves(jq, pq, "update")
    _same(jq.compute(), pq.compute())
    assert jq.n_items == pq.n_items and jq.rank_error_bound() == pq.rank_error_bound()
    js, ps = _pair("StreamingQuantile", q=0.5, capacity=10, max_items=1 << 9)
    v = _stream(3, 40)
    js.update(v)
    ps.update(torch.from_numpy(v))
    _same(js.compute(), ps.compute())


def test_forward_batch_value_starts_from_the_seed_key():
    # the batch value of each forward comes from a fresh default state (its key is
    # the seed's again), and the batch is never merged into the live state
    jq, pq = _pair("StreamingQuantile", q=1.0, capacity=64, max_items=1 << 10)
    v = np.arange(50, dtype=np.float32)
    outs = [(_np(jq(v)), _np(pq(torch.from_numpy(v)))) for _ in range(2)]
    for a, b in outs:
        _same(a, b)
    _leaves(jq, pq)
    _same(jq.compute(), pq.compute())


def test_streaming_histogram_bitwise():
    jh, ph = _pair("StreamingHistogram", bins=7, capacity=16, max_items=1 << 12)
    for step, size in enumerate((300, 301, 5)):
        v = _stream(step, size)
        jh.update(v)
        ph.update(torch.from_numpy(v))
    _leaves(jh, ph)
    _same(jh.minv, ph.minv)
    _same(jh.maxv, ph.maxv)
    jout, pout = jh.compute(), ph.compute()
    _same(jout["edges"], pout["edges"])
    _same(jout["counts"], pout["counts"])
    jz, pz = _pair("StreamingHistogram", bins=3, capacity=8, max_items=1 << 9)
    z = np.array([0.0, -0.0, 0.0], np.float32)
    jz.update(z)
    pz.update(torch.from_numpy(z))
    _same(jz.minv, pz.minv)
    _same(jz.maxv, pz.maxv)
    _same(jz.compute()["edges"], pz.compute()["edges"])
    je, pe = _pair("StreamingHistogram", bins=3, capacity=8, max_items=1 << 9)
    with pytest.warns(UserWarning):
        pout = pe.compute()
    with pytest.warns(UserWarning):
        jout = je.compute()
    _same(jout["counts"], pout["counts"])


def test_sketch_metric_core_surface():
    jq, pq = _pair("StreamingQuantile", q=0.5, capacity=8, max_items=1 << 9)
    assert pq.state_kinds() == jq.state_kinds() == {"sketch": "sketch"}
    assert pq.state_keys("sketch") == jq.state_keys("sketch")
    assert pq._schema_entries() == jq._schema_entries()
    jh, ph = _pair("StreamingHistogram", bins=4, capacity=8, max_items=1 << 9)
    assert ph.state_kinds() == jh.state_kinds()
    assert ph._schema_entries() == jh._schema_entries()
    assert pq.sketch_tree("sketch")["key"].dtype == torch.uint32
    v = torch.from_numpy(_stream(0, 120))
    pq.update(v)
    clone = pickle.loads(pickle.dumps(pq))
    _same_tree(pq.sketch_tree("sketch"), clone.sketch_tree("sketch"), "pickle")
    clone.update(v)
    pq.update(v)
    _same_tree(pq.sketch_tree("sketch"), clone.sketch_tree("sketch"), "pickle then update")
    _same(pq.compute(), clone.compute())
    pq.reset()
    _same_tree(pq.sketch_tree("sketch"), psk.kll_init(8, max_items=1 << 9, device="cpu"), "reset")
    deep = pq.clone()
    assert deep.sketch_tree("sketch")["key"].dtype == torch.uint32


def test_pure_state_api_carries_the_sketch():
    _, pq = _pair("StreamingQuantile", q=0.5, capacity=8, max_items=1 << 9)
    v = torch.from_numpy(_stream(2, 90))
    state = pq.apply_update(pq.init_state(), v)
    assert pq.n_items == 0
    pq.update(v)
    _same_tree(pq.sketch_tree("sketch"), pq.sketch_tree("sketch", state))
    _same(pq.apply_compute(state), pq.compute())


def test_merge_state_folds_the_sketches_as_the_jax_package_does():
    jq, pq = _pair("StreamingQuantile", q=0.5, capacity=8, max_items=1 << 9)
    jo, po = _pair("StreamingQuantile", q=0.5, capacity=8, max_items=1 << 9, seed=4)
    for i, (a, b) in enumerate(((jq, pq), (jo, po))):
        v = _stream(20 + i, 77)
        a.update(v)
        b.update(torch.from_numpy(v))
    jq.merge_state(jo.state_pytree())
    pq.merge_state(po.state_pytree())
    _leaves(jq, pq)
    _same(jq.compute(), pq.compute())


def test_validate_sync_lets_sketch_padding_through():
    m = mt.StreamingQuantile(q=0.5, capacity=8, max_items=1 << 9, device="cpu",
                             sync_backend=LoopbackBackend(), validate_sync=True)
    m.update(torch.from_numpy(_stream(5, 60)))
    before = {k: v.clone() for k, v in m.sketch_tree("sketch").items()}
    assert torch.isfinite(m.compute())
    report = m.last_sync_report
    assert report["error"] is None and report["delta"] is False
    _same_tree(before, m.sketch_tree("sketch"))


def test_every_streaming_name_is_exported():
    import metrics_tpu.streaming as js

    for name in js.__all__:
        assert name in mt.streaming.__all__ and hasattr(mt.streaming, name), name
    for name in ("StreamingQuantile", "StreamingHistogram", "SketchMetric", "WindowedMetric", "TimeDecayedMetric",
                 "kll_init", "kll_update", "kll_merge", "kll_quantile", "kll_cdf", "kll_total_weight",
                 "kll_rank_error_bound", "reservoir_init", "reservoir_update", "reservoir_merge", "reservoir_values"):
        assert name in mt.__all__ and hasattr(mt, name), name
