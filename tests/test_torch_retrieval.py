"""The port's retrieval metrics, functionals and engine against the JAX package.

Scores are multiples of 1/8 with ties inside queries, ``-0.0`` beside
``+0.0`` and NaN; some queries have no relevant document and some no
irrelevant one; nDCG takes graded targets 0-3.  Tolerances, with
``U = 2**-24``:

* bitwise: query groupings, the sort order, ranks and counts, the
  precision-recall table, and every per-query score that is one division of
  two exact sums (precision, recall, fall-out, hit rate, R-precision,
  reciprocal rank, the precision-recall curve);
* ``L * U`` absolute for AP per query (a sum of at most ``L`` ratios in
  [0, 1], ``L`` the longest query) and ``4 * L * U`` for nDCG per query
  (``1 / log2(rank + 2)`` may differ from XLA's in the last bit);
* ``Q * U`` absolute more for a mean over ``Q`` queries, whose sum adds in
  another order.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.functional as jf
import metrics_tpu.functional.retrieval as jfr
import metrics_tpu.retrieval as jr
import metrics_tpu_torch as mt
import metrics_tpu_torch.functional as tf
import metrics_tpu_torch.functional.retrieval as tfr
import metrics_tpu_torch.retrieval as tr
from metrics_tpu.functional.retrieval import engine as jengine
from metrics_tpu.retrieval.precision_recall_curve import _retrieval_recall_at_fixed_precision as jax_rafp
from metrics_tpu_torch.functional.retrieval import engine as tengine
from metrics_tpu_torch.interop import load_jax_state
from metrics_tpu_torch.retrieval.precision_recall_curve import _retrieval_recall_at_fixed_precision as port_rafp

U = 2.0**-24
N_ROWS, N_QUERIES = 96, 11
IGNORE = -1


def _data(seed: int = 0, graded: bool = False, ignore: bool = False):
    """Query ids (not contiguous, not sorted), eighths with ties, +-0.0 and NaN, and targets
    where query 3 has no relevant row and query 5 no irrelevant one."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(np.arange(100, 100 + 3 * N_QUERIES, 3), N_ROWS)
    ids[:N_QUERIES] = np.arange(100, 100 + 3 * N_QUERIES, 3)  # every query present
    preds = (rng.integers(-8, 9, N_ROWS) / 8).astype(np.float32)
    preds[rng.random(N_ROWS) < 0.08] = -0.0
    preds[rng.random(N_ROWS) < 0.05] = np.nan
    target = rng.integers(0, 4 if graded else 2, N_ROWS)
    target[ids == 109] = 0
    target[ids == 115] = 3 if graded else 1
    if ignore:
        target[rng.random(N_ROWS) < 0.1] = IGNORE
    return ids, preds, target


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _same(a, b, key=""):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (key, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), (key, a, b)


def _close(a, b, atol, key=""):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (key, a.dtype, b.dtype)
    np.testing.assert_allclose(a, b, rtol=0, atol=atol, equal_nan=True, err_msg=key)


def _longest(ids) -> int:
    return int(np.unique(ids, return_counts=True)[1].max())


# ------------------------------------------------------------------ the engine
def test_contiguous_groups_match_jax():
    ids, _, _ = _data()
    group, n = tengine.contiguous_groups(torch.from_numpy(ids))
    jgroup, jn = jengine.contiguous_groups(jnp.asarray(ids))
    assert n == jn == N_QUERIES
    assert np.array_equal(_np(group), np.asarray(jgroup))


@pytest.mark.parametrize("graded", [False, True])
def test_group_layout_sorts_and_ranks_as_jax(graded):
    ids, preds, target = _data(1, graded)
    jgroup, n = jengine.contiguous_groups(jnp.asarray(ids))
    group = torch.from_numpy(np.array(jgroup))
    got = tengine._group_layout(torch.from_numpy(preds), group, n)
    want = jengine._group_layout(jnp.asarray(preds), jgroup, n)
    for name, g, w in zip(("order", "g", "rank", "counts", "starts"), got, want):
        assert np.array_equal(_np(g), np.asarray(w)), name
    # the ideal order of nDCG: the same sort on -target
    ideal = tengine._order_by(group, torch.from_numpy(target.astype(np.float32)))
    assert np.array_equal(_np(ideal), np.asarray(jnp.lexsort((-jnp.asarray(target, jnp.float32), jgroup))))


EXACT_PER_GROUP = [
    ("reciprocal_rank_per_group", {}),
    ("precision_per_group", {}),
    ("precision_per_group", {"k": 3}),
    ("precision_per_group", {"k": 3, "adaptive_k": True}),
    ("precision_per_group", {"k": 50, "adaptive_k": True}),
    ("recall_per_group", {}),
    ("recall_per_group", {"k": 2}),
    ("fall_out_per_group", {}),
    ("fall_out_per_group", {"k": 2}),
    ("hit_rate_per_group", {}),
    ("hit_rate_per_group", {"k": 1}),
    ("r_precision_per_group", {}),
]


def _engine_inputs(seed, graded=False):
    ids, preds, target = _data(seed, graded)
    jgroup, n = jengine.contiguous_groups(jnp.asarray(ids))
    port = (torch.from_numpy(preds), torch.from_numpy(target.astype(np.int32)), torch.from_numpy(np.array(jgroup)), n)
    jax = (jnp.asarray(preds), jnp.asarray(target, jnp.int32), jgroup, n)
    return ids, port, jax


@pytest.mark.parametrize("name,kwargs", EXACT_PER_GROUP, ids=[f"{n}-{k}" for n, k in EXACT_PER_GROUP])
def test_per_query_scores_of_exact_sums_are_bitwise(name, kwargs):
    _, port, jax = _engine_inputs(2)
    _same(getattr(tengine, name)(*port, **kwargs), getattr(jengine, name)(*jax, **kwargs), name)


@pytest.mark.parametrize("graded", [False, True])
@pytest.mark.parametrize("k", [None, 3])
def test_ap_and_ndcg_per_query_within_their_bounds(k, graded):
    ids, port, jax = _engine_inputs(3, graded)
    longest = _longest(ids)
    if k is None and not graded:
        _close(tengine.average_precision_per_group(*port), jengine.average_precision_per_group(*jax), longest * U, "ap")
    _close(tengine.ndcg_per_group(*port, k=k), jengine.ndcg_per_group(*jax, k=k), 4 * longest * U, "ndcg")


@pytest.mark.parametrize("adaptive_k", [False, True])
@pytest.mark.parametrize("max_k", [1, 4, 40])
def test_precision_recall_table_is_bitwise(max_k, adaptive_k):
    _, port, jax = _engine_inputs(4)
    got = tengine.precision_recall_curve_per_group(*port, max_k=max_k, adaptive_k=adaptive_k)
    want = jengine.precision_recall_curve_per_group(*jax, max_k=max_k, adaptive_k=adaptive_k)
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("action", ["neg", "pos", "skip"])
@pytest.mark.parametrize("curve", [False, True])
def test_reduce_over_groups_matches_jax(action, curve):
    rng = np.random.default_rng(5)
    scores = (rng.integers(0, 9, (N_QUERIES, 4) if curve else N_QUERIES) / 8).astype(np.float32)
    empty = rng.random(N_QUERIES) < 0.3
    got = tengine.reduce_over_groups(torch.from_numpy(scores), torch.from_numpy(empty), action)
    _close(got, jengine.reduce_over_groups(jnp.asarray(scores), jnp.asarray(empty), action), N_QUERIES * U)
    none = tengine.reduce_over_groups(torch.from_numpy(scores), torch.ones(N_QUERIES, dtype=torch.bool), "skip")
    assert not bool(none.any())


def test_reduce_over_groups_raises_on_an_empty_query_under_error():
    with pytest.raises(ValueError, match="no negative target"):
        tengine.reduce_over_groups(torch.ones(3), torch.tensor([False, True, False]), "error", "negative")


def test_two_engine_runs_agree_bitwise():
    _, port, _ = _engine_inputs(6)
    for name in ("average_precision_per_group", "ndcg_per_group"):
        fn = getattr(tengine, name)
        assert fn(*port).numpy().tobytes() == fn(*port).numpy().tobytes()


# ------------------------------------------------------------------ the modules
MODULES = [
    ("RetrievalMAP", {}),
    ("RetrievalMRR", {}),
    ("RetrievalPrecision", {}),
    ("RetrievalPrecision", {"k": 3}),
    ("RetrievalPrecision", {"k": 3, "adaptive_k": True}),
    ("RetrievalRecall", {}),
    ("RetrievalRecall", {"k": 2}),
    ("RetrievalFallOut", {}),
    ("RetrievalFallOut", {"k": 2}),
    ("RetrievalHitRate", {"k": 1}),
    ("RetrievalNormalizedDCG", {}),
    ("RetrievalNormalizedDCG", {"k": 3}),
    ("RetrievalRPrecision", {}),
    ("RetrievalPrecisionRecallCurve", {"max_k": 4}),
    ("RetrievalPrecisionRecallCurve", {"max_k": 4, "adaptive_k": True}),
    ("RetrievalPrecisionRecallCurve", {}),
    ("RetrievalRecallAtFixedPrecision", {"min_precision": 0.3, "max_k": 4}),
    ("RetrievalRecallAtFixedPrecision", {"min_precision": 0.9}),
]
EAGER = {"jit_update": False, "jit_compute": False}


def _module_pair(name, kwargs, action, ignore):
    extra = {"empty_target_action": action, "ignore_index": IGNORE if ignore else None}
    return getattr(jm, name)(**kwargs, **extra, **EAGER), getattr(mt, name)(**kwargs, **extra, device="cpu")


def _feed(ref, port, ids, preds, target, splits=(0, 40, 70, N_ROWS)):
    for a, b in zip(splits[:-1], splits[1:]):
        ref.update(jnp.asarray(preds[a:b]), jnp.asarray(target[a:b]), indexes=jnp.asarray(ids[a:b]))
        port.update(torch.from_numpy(preds[a:b]), torch.from_numpy(target[a:b]), indexes=torch.from_numpy(ids[a:b]))


def _check_module(name, got, want, ids):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    per_query = 4 * _longest(ids) * U if name == "RetrievalNormalizedDCG" else _longest(ids) * U
    for g, w in zip(got, want):
        exact_dtype = _np(w).dtype.kind == "i"
        _close(g, w, 0 if exact_dtype else per_query + N_QUERIES * U, name)


@pytest.mark.parametrize("ignore", [False, True])
@pytest.mark.parametrize("action", ["neg", "pos", "skip"])
@pytest.mark.parametrize("name,kwargs", MODULES, ids=[f"{n}-{k}" for n, k in MODULES])
def test_module_matches_jax(name, kwargs, action, ignore):
    graded = name == "RetrievalNormalizedDCG"
    ids, preds, target = _data(7, graded, ignore)
    ref, port = _module_pair(name, kwargs, action, ignore)
    _feed(ref, port, ids, preds, target)
    for key in ("indexes", "preds", "target"):
        _same(port.buffer_values(key), np.asarray(ref.buffer_values(key)), key)
    _check_module(name, port.compute(), ref.compute(), ids)


@pytest.mark.parametrize("name,kwargs", MODULES, ids=[f"{n}-{k}" for n, k in MODULES])
def test_module_under_error_raises_on_an_empty_query_as_jax(name, kwargs):
    ids, preds, target = _data(8, name == "RetrievalNormalizedDCG")
    ref, port = _module_pair(name, kwargs, "error", False)
    _feed(ref, port, ids, preds, target)
    with pytest.raises(ValueError) as jerr:
        ref.compute()
    with pytest.raises(ValueError) as perr:
        port.compute()
    assert str(perr.value) == str(jerr.value)
    keep = ~np.isin(ids, [109, 115])  # without the query lacking relevant rows and the one lacking others
    ref, port = _module_pair(name, kwargs, "error", False)
    _feed(ref, port, ids[keep], preds[keep], target[keep], (0, 30, int(keep.sum())))
    _check_module(name, port.compute(), ref.compute(), ids[keep])


def test_fall_out_defaults_to_pos_and_its_empty_queries_lack_negatives():
    m = mt.RetrievalFallOut(device="cpu")
    assert m.empty_target_action == "pos" and m.higher_is_better is False
    m.update(torch.tensor([0.5, 0.25, 0.75]), torch.tensor([1, 1, 0]), indexes=torch.tensor([0, 0, 1]))
    assert float(m.compute()) == 1.0  # query 0 has no negative: 1 ("pos"); query 1 retrieves its negative: 1


def test_graded_targets_only_for_ndcg():
    preds, target, idx = torch.tensor([0.5, 0.25]), torch.tensor([2, 0]), torch.tensor([0, 0])
    mt.RetrievalNormalizedDCG(device="cpu").update(preds, target, indexes=idx)
    with pytest.raises(ValueError, match="binary"):
        mt.RetrievalMAP(device="cpu").update(preds, target, indexes=idx)


@pytest.mark.parametrize("bad,match", [
    ({"indexes": None}, "cannot be None"),
    ({"indexes": torch.tensor([0.0, 1.0])}, "long integers"),
    ({"preds": torch.tensor([1, 0])}, "floats"),
    ({"target": torch.tensor([0, 1, 1])}, "same shape"),
])
def test_input_checks_raise_as_jax(bad, match):
    args = {"preds": torch.tensor([0.5, 0.25]), "target": torch.tensor([1, 0]), "indexes": torch.tensor([0, 0])}
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        mt.RetrievalMAP(device="cpu").update(**args)


def test_a_batch_whose_rows_are_all_ignored_raises():
    with pytest.raises(ValueError, match="non-empty"):
        mt.RetrievalMAP(ignore_index=0, device="cpu").update(torch.tensor([0.5]), torch.tensor([0]), indexes=torch.tensor([1]))


def test_buffers_hold_int32_ids_float32_scores_and_targets_as_jax():
    ids, preds, target = _data(9)
    for tgt in (target.astype(bool), target.astype(np.int64), target.astype(np.float64)):
        port = mt.RetrievalMAP(device="cpu")
        port.update(torch.from_numpy(preds.astype(np.float64)), torch.from_numpy(tgt), indexes=torch.from_numpy(ids))
        ref = jm.RetrievalMAP(**EAGER)
        ref.update(jnp.asarray(preds), jnp.asarray(tgt), indexes=jnp.asarray(ids))
        for key in ("indexes", "preds", "target"):
            _same(port.buffer_values(key), np.asarray(ref.buffer_values(key)), key)


class _UserRecall(tr.RetrievalMetric):
    """A subclass that writes only the per-query ``_metric``."""

    def _metric(self, preds, target):
        return tf.retrieval_recall(preds, target, k=2)


def test_a_subclass_with_only_metric_loops_the_queries():
    ids, preds, target = _data(10)
    mine, builtin = _UserRecall(device="cpu"), mt.RetrievalRecall(k=2, device="cpu")
    for m in (mine, builtin):
        m.update(torch.from_numpy(preds), torch.from_numpy(target), indexes=torch.from_numpy(ids))
    _close(mine.compute(), builtin.compute(), N_QUERIES * U)


def test_module_pickles_and_loads_jax_state_mid_stream():
    ids, preds, target = _data(11)
    ref, port = _module_pair("RetrievalMAP", {}, "neg", False)
    _feed(ref, port, ids[:50], preds[:50], target[:50], (0, 50))
    loaded = mt.RetrievalMAP(device="cpu")
    load_jax_state(loaded, ref.state_pytree())
    clone = pickle.loads(pickle.dumps(port))
    ref.update(jnp.asarray(preds[50:]), jnp.asarray(target[50:]), indexes=jnp.asarray(ids[50:]))
    for m in (loaded, clone):
        m.update(torch.from_numpy(preds[50:]), torch.from_numpy(target[50:]), indexes=torch.from_numpy(ids[50:]))
    _same(loaded.compute(), clone.compute())
    _check_module("RetrievalMAP", loaded.compute(), ref.compute(), ids)


@pytest.mark.parametrize("with_nan", [False, True])
def test_retrieval_collection_groups_as_jax(with_nan):
    """Members with equal buffers share one; a NaN score keeps them apart, as ``allclose`` does in both packages."""
    ids, preds, target = _data(12)
    if not with_nan:
        preds = np.nan_to_num(preds)
    col = mt.MetricCollection({"map": mt.RetrievalMAP(device="cpu"), "mrr": mt.RetrievalMRR(device="cpu"),
                               "ndcg": mt.RetrievalNormalizedDCG(k=3, device="cpu")}, device="cpu")
    ref = jm.MetricCollection({"map": jm.RetrievalMAP(**EAGER), "mrr": jm.RetrievalMRR(**EAGER),
                               "ndcg": jm.RetrievalNormalizedDCG(k=3, **EAGER)})
    for a, b in ((0, 40), (40, N_ROWS)):
        col.update(torch.from_numpy(preds[a:b]), torch.from_numpy(target[a:b]), indexes=torch.from_numpy(ids[a:b]))
        ref.update(jnp.asarray(preds[a:b]), jnp.asarray(target[a:b]), indexes=jnp.asarray(ids[a:b]))
    assert list(col.compute_groups.values()) == list(ref.compute_groups.values())
    assert len(col.compute_groups) == (3 if with_nan else 1)
    alone = mt.RetrievalNormalizedDCG(k=3, device="cpu")
    alone.update(torch.from_numpy(preds), torch.from_numpy(target), indexes=torch.from_numpy(ids))
    _same(col.compute()["ndcg"], alone.compute())
    want = ref.compute()
    for key, value in col.compute().items():
        _check_module(type(col[key]).__name__, value, want[key], ids)


# ------------------------------------------------------------------ the functionals
FUNCTIONALS = [
    ("retrieval_average_precision", {}),
    ("retrieval_reciprocal_rank", {}),
    ("retrieval_precision", {"k": 2}),
    ("retrieval_precision", {"k": 20, "adaptive_k": True}),
    ("retrieval_precision", {}),
    ("retrieval_recall", {"k": 2}),
    ("retrieval_recall", {}),
    ("retrieval_fall_out", {"k": 2}),
    ("retrieval_fall_out", {}),
    ("retrieval_hit_rate", {"k": 1}),
    ("retrieval_hit_rate", {}),
    ("retrieval_normalized_dcg", {"k": 3}),
    ("retrieval_normalized_dcg", {}),
    ("retrieval_r_precision", {}),
    ("retrieval_precision_recall_curve", {"max_k": 4}),
    ("retrieval_precision_recall_curve", {"max_k": 20, "adaptive_k": True}),
    ("retrieval_precision_recall_curve", {}),
]


def _queries():
    """Single queries: ties, +-0.0, NaN, no relevant document, all relevant, graded."""
    q = np.array([0.5, -0.0, 0.0, np.nan, 0.5, 0.25, -0.25, 0.0, 0.125, 0.5], np.float32)
    return [
        (q, np.array([0, 1, 0, 1, 1, 0, 0, 1, 0, 0])),
        (q, np.zeros(10, np.int64)),
        (q, np.ones(10, np.int64)),
        (q[::-1].copy(), np.array([1, 0, 0, 0, 1, 0, 0, 1, 0, 0])),
        (np.array([0.25, 0.25, 0.25], np.float32), np.array([0, 0, 1])),
    ]


@pytest.mark.parametrize("which", range(5))
@pytest.mark.parametrize("name,kwargs", FUNCTIONALS, ids=[f"{n}-{k}" for n, k in FUNCTIONALS])
def test_functional_matches_jax(name, kwargs, which):
    preds, target = _queries()[which]
    if name == "retrieval_normalized_dcg" and which == 3:
        target = target * 3
    got = getattr(tf, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    want = getattr(jf, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        if name == "retrieval_normalized_dcg":
            _close(g, w, 4 * len(preds) * U, name)
        elif name == "retrieval_average_precision":
            _close(g, w, len(preds) * U, name)
        else:
            _same(g, w, name)


@pytest.mark.parametrize("name", ["retrieval_precision", "retrieval_recall", "retrieval_fall_out", "retrieval_hit_rate",
                                  "retrieval_normalized_dcg"])
def test_functional_k_must_be_a_positive_int(name):
    with pytest.raises(ValueError, match="`k` has to be a positive integer"):
        getattr(tf, name)(torch.tensor([0.5]), torch.tensor([1]), k=0)


def test_functional_input_checks():
    with pytest.raises(ValueError, match="same shape"):
        tf.retrieval_recall(torch.tensor([0.5, 0.1]), torch.tensor([1]))
    with pytest.raises(ValueError, match="non-empty"):
        tf.retrieval_recall(torch.tensor(0.5), torch.tensor(1))
    with pytest.raises(ValueError, match="binary"):
        tf.retrieval_recall(torch.tensor([0.5, 0.1]), torch.tensor([2, 0]))
    with pytest.raises(ValueError, match="max_k"):
        tf.retrieval_precision_recall_curve(torch.tensor([0.5]), torch.tensor([1]), max_k=0)


@pytest.mark.parametrize("case", ["tie_goes_to_largest_k", "zero_recall", "no_candidate", "plain"])
def test_recall_at_fixed_precision_breaks_ties_as_jax(case):
    p = {"tie_goes_to_largest_k": [1.0, 0.5, 0.5, 0.25], "zero_recall": [0.0, 0.0, 0.5, 0.5],
         "no_candidate": [0.1, 0.1, 0.1, 0.1], "plain": [1.0, 0.75, 0.5, 0.25]}[case]
    r = {"tie_goes_to_largest_k": [0.25, 0.5, 0.5, 0.5], "zero_recall": [0.0, 0.0, 0.0, 0.0],
         "no_candidate": [0.5, 0.5, 0.5, 0.5], "plain": [0.25, 0.5, 0.75, 1.0]}[case]
    p, r = np.float32(p), np.float32(r)
    k = np.arange(1, 5, dtype=np.int32)
    got = port_rafp(torch.from_numpy(p), torch.from_numpy(r), torch.from_numpy(k), 0.4)
    want = jax_rafp(jnp.asarray(p), jnp.asarray(r), jnp.asarray(k), 0.4)
    for g, w in zip(got, want):
        _same(g, w, case)


# ------------------------------------------------------------------ the surface
def test_every_retrieval_name_of_the_jax_package_is_exported():
    assert set(jr.__all__) <= set(tr.__all__)
    assert set(jr.__all__) - {"RetrievalMetric"} <= set(mt.__all__)
    assert set(jfr.__all__) <= set(tfr.__all__) <= set(tf.__all__) <= set(mt.__all__)
    for name in jfr.__all__:
        assert getattr(mt, name) is getattr(tf, name) is getattr(tfr, name)
    for name in set(jr.__all__) - {"RetrievalMetric"}:
        assert getattr(mt, name) is getattr(tr, name)
