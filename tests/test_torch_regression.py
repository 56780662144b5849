"""The port's regression metrics against the JAX package, on the CPU.

The same numpy inputs (made from a seed) go through ``metrics_tpu`` and
``metrics_tpu_torch``.  Tolerances, in units of float32 rounding
(``U = 2**-24``):

* On inputs that are multiples of 1/8 (small, so every product and sum is
  exact in float32) the sums and counts match bitwise, and so do the scores
  built from them by the same correctly rounded operations: MSE, RMSE, MAE,
  WMAPE, R² and explained variance.
* Elsewhere a state is a float32 sum of ``n`` terms added in another order
  (XLA's and torch's): ``SUM_RTOL = n * U`` relative for terms of one sign.
  ``log``, ``log1p``, ``pow`` and ``xlogy`` may differ in the last bit between
  XLA and torch, which adds ``U`` per term: within the same bound.
* Scores that cancel (R², explained variance, Pearson, Spearman) are held to
  ``CANCEL_ATOL = 8 * n * U`` absolute on values of order one: each of their
  sums carries ``n * U`` of its magnitude, and the data here keeps the
  magnitudes within a few times the differences.
* Counts (int32) and state dtypes and shapes are bitwise; Spearman's ranks
  are bitwise against ``jnp``'s on ties, ``-0.0``/``+0.0``, ``+-inf`` and NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.functional as jf
import metrics_tpu.parallel as jp
import metrics_tpu_torch as mt
import metrics_tpu_torch.functional as tf
import metrics_tpu_torch.parallel as tp
from metrics_tpu.functional.regression.spearman import _rank_data as jax_rank_data
from metrics_tpu.regression.pearson import _final_aggregation as jax_final_aggregation
from metrics_tpu_torch.functional.regression.spearman import _rank_data
from metrics_tpu_torch.regression.pearson import _final_aggregation
from tests.test_torch_buffer_states import _recording

EAGER = {"jit_update": False, "jit_compute": False}
N, D, BATCHES = 64, 3, 4
U = 2.0**-24
N_TERMS = N * D * BATCHES  # the most terms any state here sums
SUM_RTOL = N_TERMS * U
CANCEL_ATOL = 8 * N_TERMS * U


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_bitwise(port, ref) -> None:
    got, want = _np(port), _np(ref)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), (got, want)


def assert_close(port, ref, rtol=SUM_RTOL, atol=0.0) -> None:
    got, want = _np(port), _np(ref)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, equal_nan=True)


def _pair(shape, seed: int, dyadic: bool, positive: bool = False):
    """(preds, target) float32: eighths in [-4, 4] (or (0, 4] when positive), else normal (or log-normal) draws."""
    rng = np.random.default_rng(seed)
    if dyadic:
        low = 1 if positive else -32
        target = rng.integers(low, 33, shape) / 8
        preds = np.clip(target + rng.integers(-4, 5, shape) / 8, 1 / 8 if positive else -4, 4)
    else:
        target = rng.standard_normal(shape)
        preds = target + 0.5 * rng.standard_normal(shape)
        if positive:
            target, preds = np.exp(target), np.exp(preds)
    return preds.astype(np.float32), target.astype(np.float32)


def _batches(shape, seed: int, dyadic: bool, positive: bool = False):
    return [_pair(shape, seed + i, dyadic, positive) for i in range(BATCHES)]


# ------------------------------------------------------------ functionals
# name -> (kwargs, positive inputs, exact on eighths, cancels)
FUNCTIONALS = {
    "mean_squared_error": ({}, False, True, False),
    "mean_squared_error-rmse": ({"squared": False}, False, True, False),
    "mean_absolute_error": ({}, False, True, False),
    "mean_squared_log_error": ({}, True, False, False),
    "mean_absolute_percentage_error": ({}, False, False, False),
    "symmetric_mean_absolute_percentage_error": ({}, False, False, False),
    "weighted_mean_absolute_percentage_error": ({}, False, True, False),
    "tweedie_deviance_score-0": ({"power": 0}, False, True, False),
    "tweedie_deviance_score-1": ({"power": 1}, True, False, False),
    "tweedie_deviance_score-1.5": ({"power": 1.5}, True, False, False),
    "tweedie_deviance_score-2": ({"power": 2}, True, False, False),
    "tweedie_deviance_score-3": ({"power": 3}, True, False, False),
    "tweedie_deviance_score--1": ({"power": -1.0}, True, False, False),
    "explained_variance": ({}, False, True, True),
    "r2_score": ({}, False, True, True),
    "r2_score-adjusted": ({"adjusted": 5}, False, True, True),
    "pearson_corrcoef": ({}, False, False, True),
    "spearman_corrcoef": ({}, False, False, True),
}
MULTIOUTPUT = ("raw_values", "uniform_average", "variance_weighted")


@pytest.mark.parametrize("dyadic", [True, False], ids=["eighths", "random"])
@pytest.mark.parametrize("case", FUNCTIONALS)
def test_functionals_match_jax(case, dyadic):
    kwargs, positive, exact, cancels = FUNCTIONALS[case]
    name = case.split("-")[0]
    preds, target = _pair((N,), 11, dyadic, positive)
    got = getattr(tf, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    want = getattr(jf, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    if dyadic and exact:
        assert_bitwise(got, want)
    else:
        assert_close(got, want, atol=CANCEL_ATOL if cancels else 0.0)


@pytest.mark.parametrize("dyadic", [True, False], ids=["eighths", "random"])
@pytest.mark.parametrize("multioutput", MULTIOUTPUT)
@pytest.mark.parametrize("name", ["explained_variance", "r2_score"])
def test_multioutput_functionals_match_jax(name, multioutput, dyadic):
    preds, target = _pair((N, D), 12, dyadic)
    got = getattr(tf, name)(torch.from_numpy(preds), torch.from_numpy(target), multioutput=multioutput)
    want = getattr(jf, name)(jnp.asarray(preds), jnp.asarray(target), multioutput=multioutput)
    if dyadic and multioutput == "raw_values":
        assert_bitwise(got, want)
    else:  # the D scores are quotients, and their mean or weighted sum adds them in another order
        assert_close(got, want, rtol=0.0, atol=CANCEL_ATOL)


def test_explained_variance_division_policy_matches_jax():
    """A constant error gives a zero numerator (score 1); a constant target a zero denominator (score 0)."""
    target = np.array([[1.0, 2.0, 3.0], [1.0, 5.0, 3.0], [1.0, -1.0, 3.0]], np.float32)
    preds = np.array([[0.0, 1.0, 3.0], [2.0, 4.0, 3.0], [1.0, -2.0, 3.0]], np.float32)
    for multioutput in MULTIOUTPUT:
        got = tf.explained_variance(torch.from_numpy(preds), torch.from_numpy(target), multioutput=multioutput)
        assert_bitwise(got, jf.explained_variance(jnp.asarray(preds), jnp.asarray(target), multioutput=multioutput))
    assert _np(tf.explained_variance(torch.from_numpy(preds), torch.from_numpy(target), "raw_values")).tolist() == [0.0, 1.0, 1.0]


@pytest.mark.parametrize("reduction", ["sum", "mean", "none", None])
def test_cosine_similarity_matches_jax(reduction):
    preds, target = _pair((N, D), 13, False)
    got = tf.cosine_similarity(torch.from_numpy(preds), torch.from_numpy(target), reduction=reduction)
    want = jf.cosine_similarity(jnp.asarray(preds), jnp.asarray(target), reduction=reduction)
    # a similarity carries a few U from its D-term sums, the norms and the quotient, and a sum
    # or mean over N rows up to N U more: (N + 32) U per row, N times that for the sum
    assert_close(got, want, rtol=0.0, atol=(N + 32) * U * (N if reduction == "sum" else 1))


def test_degenerate_adjusted_r2_warns_like_jax(recwarn):
    preds, target = _pair((4,), 14, True)
    from metrics_tpu_torch.obs import logging as obs_logging

    obs_logging._warned.discard(("UserWarning", "r2.adjusted_degenerate"))
    got = tf.r2_score(torch.from_numpy(preds), torch.from_numpy(target), adjusted=3)
    assert any("More independent regressions" in str(w.message) for w in recwarn.list)
    assert_bitwise(got, jf.r2_score(jnp.asarray(preds), jnp.asarray(target), adjusted=3))


# --------------------------------------------------------------- spearman
TRICKY = np.array([3.0, np.nan, -0.0, 0.0, 1.0, 1.0, -np.nan, -np.inf, np.inf, 1.0, -2.5, np.nan], np.float32)
SEARCHSORTED_TRAP = np.array([3.0, np.nan, -0.0, 0.0, 1.0, 1.0, np.nan, -np.inf], np.float32)  # torch.searchsorted misplaces 3.0 and 1.0
_jax_ranks = jax.jit(jax_rank_data)  # one compile per length and dtype, shared by the cases


def _rank_cases():
    """Every case has N values, so the JAX ranks compile once per dtype."""
    rng = np.random.default_rng(15)
    return {
        "tricky": rng.choice(TRICKY, N),  # ties, -0.0 and +0.0, +-inf, NaN and -NaN
        "searchsorted_trap": np.tile(SEARCHSORTED_TRAP, N // len(SEARCHSORTED_TRAP)),
        "ties": np.round(rng.standard_normal(N) * 2),
        "distinct": rng.standard_normal(N),
        "all_nan": np.where(rng.random(N) < 0.5, np.nan, -np.nan),
    }


RANK_CASES = _rank_cases()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", RANK_CASES)
def test_ranks_equal_jnp_ranks_bitwise(case, dtype):
    x = torch.from_numpy(RANK_CASES[case].astype(np.float32)).to(dtype)
    want = _jax_ranks(jnp.asarray(x.to(torch.float32).numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32))
    assert_bitwise(_rank_data(x), want)


def test_one_value_ranks_one():
    assert_bitwise(_rank_data(torch.tensor([5.0])), jax_rank_data(jnp.asarray([5.0], jnp.float32)))


def test_spearman_with_nan_and_ties_matches_jax():
    preds, target = RANK_CASES["tricky"], np.roll(RANK_CASES["tricky"], 3)
    got = tf.spearman_corrcoef(torch.from_numpy(preds), torch.from_numpy(target))
    assert_close(got, jf.spearman_corrcoef(jnp.asarray(preds), jnp.asarray(target)), rtol=0.0, atol=CANCEL_ATOL)


# ------------------------------------------------------------------ modules
def _module_cases():
    return {
        "mse": (lambda pkg, **kw: pkg.MeanSquaredError(**kw), (N,), False, True),
        "rmse": (lambda pkg, **kw: pkg.MeanSquaredError(squared=False, **kw), (N,), False, True),
        "mae": (lambda pkg, **kw: pkg.MeanAbsoluteError(**kw), (N,), False, True),
        "msle": (lambda pkg, **kw: pkg.MeanSquaredLogError(**kw), (N,), True, False),
        "mape": (lambda pkg, **kw: pkg.MeanAbsolutePercentageError(**kw), (N,), False, False),
        "smape": (lambda pkg, **kw: pkg.SymmetricMeanAbsolutePercentageError(**kw), (N,), False, False),
        "wmape": (lambda pkg, **kw: pkg.WeightedMeanAbsolutePercentageError(**kw), (N,), False, True),
        "tweedie_1": (lambda pkg, **kw: pkg.TweedieDevianceScore(power=1, **kw), (N,), True, False),
        "tweedie_2": (lambda pkg, **kw: pkg.TweedieDevianceScore(power=2, **kw), (N,), True, False),
        "tweedie_2.5": (lambda pkg, **kw: pkg.TweedieDevianceScore(power=2.5, **kw), (N,), True, False),
        "ev": (lambda pkg, **kw: pkg.ExplainedVariance(**kw), (N,), False, True),
        "ev_raw_2d": (lambda pkg, **kw: pkg.ExplainedVariance(multioutput="raw_values", **kw), (N, D), False, True),
        "ev_weighted_2d": (lambda pkg, **kw: pkg.ExplainedVariance(multioutput="variance_weighted", **kw), (N, D), False, False),
        "r2": (lambda pkg, **kw: pkg.R2Score(**kw), (N,), False, True),
        "r2_adjusted": (lambda pkg, **kw: pkg.R2Score(adjusted=3, **kw), (N,), False, True),
        "r2_outputs_raw": (lambda pkg, **kw: pkg.R2Score(num_outputs=D, multioutput="raw_values", **kw), (N, D), False, True),
        "r2_outputs_weighted": (lambda pkg, **kw: pkg.R2Score(num_outputs=D, multioutput="variance_weighted", **kw), (N, D), False, False),
        "r2_one_output_2d": (lambda pkg, **kw: pkg.R2Score(**kw), (N, D), False, False),
        "pearson": (lambda pkg, **kw: pkg.PearsonCorrCoef(**kw), (N,), False, False),
        "spearman": (lambda pkg, **kw: pkg.SpearmanCorrCoef(**kw), (N,), False, False),
        "cosine_sum": (lambda pkg, **kw: pkg.CosineSimilarity(**kw), (N, D), False, False),
        "cosine_mean": (lambda pkg, **kw: pkg.CosineSimilarity(reduction="mean", **kw), (N, D), False, False),
        "cosine_none": (lambda pkg, **kw: pkg.CosineSimilarity(reduction="none", **kw), (N, D), False, False),
    }


MODULES = _module_cases()
CANCELLING = ("ev", "r2", "pearson", "spearman", "cosine")


def _check_module_value(case, got, want, dyadic, exact):
    if dyadic and exact:
        assert_bitwise(got, want)
    elif case.startswith(CANCELLING):
        assert_close(got, want, rtol=0.0, atol=CANCEL_ATOL * (N if case == "cosine_sum" else 1))
    else:
        assert_close(got, want)


@pytest.mark.parametrize("dyadic", [True, False], ids=["eighths", "random"])
@pytest.mark.parametrize("case", MODULES)
def test_modules_stream_like_jax(case, dyadic):
    """update per batch, ``forward`` on the last, ``compute`` after each; then ``reset`` and one more batch."""
    make, shape, positive, exact = MODULES[case]
    ref, port = make(jm, **EAGER), make(mt, device="cpu")
    batches = _batches(shape, 20, dyadic, positive)
    buffered = bool(port._buffer_states)  # a compute per step would rank every prefix length anew
    for i, (preds, target) in enumerate(batches):
        if i == len(batches) - 1:
            _check_module_value(case, port(torch.from_numpy(preds), torch.from_numpy(target)),
                                ref(jnp.asarray(preds), jnp.asarray(target)), dyadic, exact)
        else:
            ref.update(jnp.asarray(preds), jnp.asarray(target))
            port.update(torch.from_numpy(preds), torch.from_numpy(target))
        if not buffered or i == len(batches) - 1:
            _check_module_value(case, port.compute(), ref.compute(), dyadic, exact)
    for name, value in ref.state_pytree().items():
        if name == "_update_count":
            assert port.update_count == value
            continue
        have = getattr(port, name) if not name.endswith("__len") else port.state_pytree()[name]
        assert _np(have).dtype == np.asarray(value).dtype and _np(have).shape == np.asarray(value).shape, name
    assert port._schema_entries() == ref._schema_entries()
    ref.reset()
    port.reset()
    preds, target = batches[0]
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    port.update(torch.from_numpy(preds), torch.from_numpy(target))
    _check_module_value(case, port.compute(), ref.compute(), dyadic, exact)


def test_counts_are_int32_and_sums_float32_like_jax():
    for make, shape, positive, _ in MODULES.values():
        ref, port = make(jm, **EAGER), make(mt, device="cpu")
        assert port._schema_entries() == ref._schema_entries()
        for name, default in ref._defaults.items():
            if not isinstance(default, list) and not name.endswith("__len"):
                assert _np(port._defaults[name]).dtype == np.asarray(default).dtype, name


# ------------------------------------------------------------------- errors
def test_errors_match_jax():
    good = np.ones(4, np.float32)
    cases = [
        (RuntimeError, "mean_squared_error", (good, np.ones(5, np.float32)), {}),
        (RuntimeError, "mean_absolute_error", (good, np.ones((4, 1), np.float32)), {}),
        (ValueError, "r2_score", (np.ones((2, 2, 2), np.float32),) * 2, {}),
        (ValueError, "r2_score", (good, good), {"multioutput": "median"}),
        (ValueError, "r2_score", (good, good), {"adjusted": -1}),
        (ValueError, "explained_variance", (good, good), {"multioutput": "median"}),
        (ValueError, "pearson_corrcoef", (np.ones((3, 2), np.float32),) * 2, {}),
        (TypeError, "spearman_corrcoef", (np.ones(4, np.int32), good), {}),
        (ValueError, "spearman_corrcoef", (np.ones((3, 2), np.float32),) * 2, {}),
        (ValueError, "cosine_similarity", (good, good), {}),
        (ValueError, "cosine_similarity", (np.ones((3, 2), np.float32),) * 2, {"reduction": "max"}),
        (ValueError, "tweedie_deviance_score", (good, good), {"power": 0.5}),
        (ValueError, "tweedie_deviance_score", (-good, good), {"power": 1}),
        (ValueError, "tweedie_deviance_score", (good, -good), {"power": 1.5}),
        (ValueError, "tweedie_deviance_score", (good, 0 * good), {"power": 2}),
        (ValueError, "tweedie_deviance_score", (0 * good, good), {"power": -2}),
    ]
    for error, name, args, kwargs in cases:
        with pytest.raises(error):
            getattr(jf, name)(*map(jnp.asarray, args), **kwargs)
        with pytest.raises(error):
            getattr(tf, name)(*map(torch.from_numpy, args), **kwargs)
    # a NaN breaks no domain rule, as in numpy
    nan = np.array([np.nan, 1.0], np.float32)
    assert_close(tf.tweedie_deviance_score(torch.from_numpy(nan), torch.from_numpy(nan), power=2),
                 jf.tweedie_deviance_score(jnp.asarray(nan), jnp.asarray(nan), power=2))
    for make in (lambda pkg, **kw: pkg.TweedieDevianceScore(power=0.3, **kw),
                 lambda pkg, **kw: pkg.R2Score(adjusted=-2, **kw),
                 lambda pkg, **kw: pkg.R2Score(multioutput="median", **kw),
                 lambda pkg, **kw: pkg.ExplainedVariance(multioutput="median", **kw),
                 lambda pkg, **kw: pkg.CosineSimilarity(reduction="max", **kw)):
        with pytest.raises(ValueError):
            make(jm)
        with pytest.raises(ValueError):
            make(mt, device="cpu")
    port = mt.TweedieDevianceScore(power=2, device="cpu")
    with pytest.raises(ValueError, match="strictly positive"):
        port.update(torch.from_numpy(good), torch.from_numpy(-good))
    assert port.update_count == 1 and int(port.num_observations) == 0  # nothing was added


# ----------------------------------------------------- state across packages
LOADED = ["mse", "mae", "msle", "wmape", "tweedie_2", "ev_raw_2d", "r2_outputs_raw", "r2_one_output_2d", "pearson", "spearman", "cosine_mean"]


@pytest.mark.parametrize("case", LOADED)
def test_state_loaded_from_jax_mid_stream_finishes_equal(case):
    make, shape, positive, exact = MODULES[case]
    ref = make(jm, **EAGER)
    batches = _batches(shape, 30, True, positive)
    for preds, target in batches[:2]:
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    port = make(mt, device="cpu")
    mt.load_jax_state(port, {k: v if k == "_update_count" else np.asarray(v) for k, v in ref.state_pytree().items()})
    assert port.update_count == 2
    for preds, target in batches[2:]:
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
    _check_module_value(case, port.compute(), ref.compute(), True, exact)


def test_widened_states_load_and_impossible_ones_raise():
    """A multi-output ``ExplainedVariance`` and a one-vs-all ``HingeLoss`` widen scalar states on
    their first update; both load from the JAX package mid-stream and finish equal to it.  A
    wrong dtype, or a shape the metric could never hold, still raises."""
    ref, port = jm.ExplainedVariance(multioutput="raw_values", **EAGER), mt.ExplainedVariance(multioutput="raw_values", device="cpu")
    batches = _batches((N, D), 31, True)
    ref.update(*map(jnp.asarray, batches[0]))
    state = {k: v if k == "_update_count" else np.asarray(v) for k, v in ref.state_pytree().items()}
    assert state["sum_error"].shape == (D,) and state["n_obs"].shape == ()
    mt.load_jax_state(port, state)
    for preds, target in batches[1:]:
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert_bitwise(port.compute(), ref.compute())

    rng = np.random.default_rng(32)
    scores = [(rng.integers(-24, 25, (N, 5)) / 8).astype(np.float32) for _ in range(3)]
    labels = [rng.integers(0, 5, N) for _ in range(3)]
    ref_h = jm.HingeLoss(multiclass_mode="one-vs-all", **EAGER)
    port_h = mt.HingeLoss(multiclass_mode="one-vs-all", device="cpu")
    ref_h.update(jnp.asarray(scores[0]), jnp.asarray(labels[0]))
    mt.load_jax_state(port_h, {k: v if k == "_update_count" else np.asarray(v) for k, v in ref_h.state_pytree().items()})
    for s, y in zip(scores[1:], labels[1:]):
        ref_h.update(jnp.asarray(s), jnp.asarray(y))
        port_h.update(torch.from_numpy(s), torch.from_numpy(y))
    assert_bitwise(port_h.compute(), ref_h.compute())

    bad = [
        ("sum_error", state["sum_error"].astype(np.float64), "float64"),  # wrong dtype
        ("n_obs", np.zeros(D, np.float32), "n_obs"),  # a count that never widens
    ]
    for name, value, match in bad:
        with pytest.raises(ValueError, match=match):
            mt.load_jax_state(mt.ExplainedVariance(device="cpu"), {**state, name: value})
    with pytest.raises(ValueError, match="measure"):
        mt.load_jax_state(mt.HingeLoss(multiclass_mode="one-vs-all", device="cpu"),
                          {"measure": np.zeros((5, 5), np.float32), "total": np.int32(3)})
    with pytest.raises(ValueError, match="sum_error"):  # num_outputs fixes the width
        mt.load_jax_state(mt.R2Score(num_outputs=D, device="cpu"), {"sum_error": np.zeros(D + 1, np.float32)})
    with pytest.raises(ValueError, match="only a scalar"):
        mt.MeanMetric(device="cpu").add_state("wide", torch.zeros(3), "sum", widen_ndim=1)


# ------------------------------------------------------------------ pearson
def _per_rank_rows(pkg, shards, **kwargs):
    """Each shard through its own Pearson metric; the six states stacked, one row per shard."""
    metrics = []
    for shard in shards:
        m = pkg.PearsonCorrCoef(**kwargs)
        for preds, target in shard:
            m.update(preds, target)
        metrics.append(m)
    names = ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")
    return {n: np.concatenate([_np(getattr(m, n) if pkg is mt else m._state[n]) for m in metrics]) for n in names}


def test_final_aggregation_matches_jax_over_three_ranks():
    batches = _batches((N,), 40, False)
    shards = [batches[:1], batches[1:3], batches[3:]]
    rows = _per_rank_rows(jm, [[tuple(map(jnp.asarray, b)) for b in s] for s in shards], **EAGER)
    port_rows = _per_rank_rows(mt, [[tuple(map(torch.from_numpy, b)) for b in s] for s in shards], device="cpu")
    for name, value in rows.items():
        assert_close(port_rows[name], value, rtol=0.0, atol=CANCEL_ATOL * max(1.0, float(np.abs(value).max())))
    # the same rows through both merges: the same operations in the same order
    got = _final_aggregation(*(torch.from_numpy(rows[n]) for n in rows))
    want = jax_final_aggregation(*(jnp.asarray(rows[n]) for n in rows))
    for g, w in zip(got, want):
        assert_close(g, w, rtol=4 * U)
    port = mt.PearsonCorrCoef(device="cpu")
    port.load_state_pytree(dict(rows))  # a synced state: one row per rank
    ref = jm.PearsonCorrCoef(**EAGER)
    for preds, target in batches:
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    assert_close(port.compute(), ref.compute(), rtol=0.0, atol=CANCEL_ATOL)


def test_pearson_delta_sync_rounds_equal_a_full_gather_twin():
    """Pearson's states are overwritten every update, so the delta cache must refuse the prefix and
    gather in full: every round equals a ``delta_sync=False`` twin.  (The JAX package serves the
    stale prefix of round 1 here.)  A ``CatMetric`` beside it still syncs by delta."""
    port = mt.PearsonCorrCoef(device="cpu", sync_backend=tp.LoopbackBackend())
    twin = mt.PearsonCorrCoef(device="cpu", sync_backend=tp.LoopbackBackend(), delta_sync=False)
    cat = mt.CatMetric(device="cpu", sync_backend=tp.LoopbackBackend())
    ref = jm.PearsonCorrCoef(sync_backend=jp.LoopbackBackend(), delta_sync=False, **EAGER)
    for rnd, (preds, target) in enumerate(_batches((N,), 41, False)[:3]):
        for m in (port, twin):
            m.update(torch.from_numpy(preds), torch.from_numpy(target))
        cat.update(torch.from_numpy(preds))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        assert_bitwise(port.compute(), twin.compute())
        assert_close(port.compute(), ref.compute(), rtol=0.0, atol=CANCEL_ATOL)
        assert port.last_sync_report["delta"] is False
        cat.compute()
        assert cat.last_sync_report["delta"] is (rnd > 0)
    port.compute()  # no update since the last sync: the prefix still holds
    assert port._build_delta_plan() is not None


def test_synced_pearson_and_spearman_blobs_equal_the_jax_package():
    for make, shape in ((lambda pkg, **kw: pkg.PearsonCorrCoef(**kw), (N,)),
                        (lambda pkg, **kw: pkg.SpearmanCorrCoef(**kw), (N,)),
                        (lambda pkg, **kw: pkg.R2Score(num_outputs=D, **kw), (N, D))):
        jb, tb = _recording(jp), _recording(tp)
        ref, port = make(jm, sync_backend=jb, **EAGER), make(mt, sync_backend=tb, device="cpu")
        for preds, target in _batches(shape, 42, True)[:2]:
            ref.update(jnp.asarray(preds), jnp.asarray(target))
            port.update(torch.from_numpy(preds), torch.from_numpy(target))
        mt.load_jax_state(port, ref.state_pytree())  # Pearson's running means differ in the last bit
        assert port._schema_entries() == ref._schema_entries()
        np.testing.assert_array_equal(tp.schema_digest_rows(port._schema_entries()), jp.schema_digest_rows(ref._schema_entries()))
        got, want = port.compute(), ref.compute()
        assert len(tb.blobs) == len(jb.blobs) == 1 and tb.blobs == jb.blobs
        assert_close(got, want, rtol=0.0, atol=CANCEL_ATOL)


def test_every_regression_name_of_the_jax_package_is_exported():
    import metrics_tpu.functional.regression as jfr
    import metrics_tpu.regression as jr
    import metrics_tpu_torch.functional.regression as tfr
    import metrics_tpu_torch.regression as tr

    assert set(jr.__all__) <= set(tr.__all__) <= set(mt.__all__)
    for name in jr.__all__:
        assert getattr(mt, name) is getattr(tr, name)
    assert set(jfr.__all__) <= set(tfr.__all__) <= set(tf.__all__) <= set(mt.__all__)
    for name in jfr.__all__:
        assert getattr(mt, name) is getattr(tf, name) is getattr(tfr, name)
