"""The port's multilabel ranking metrics against the JAX package, on the CPU.

``CoverageError``, ``LabelRankingAveragePrecision`` and ``LabelRankingLoss``
(modules and functionals) take the same numpy inputs (made from a seed) in
both packages: scores on a grid of quarters (most rows tie), with ``+-0.0``,
NaN of either sign and ``+-inf`` in some cases, a row with no relevant
label, a row where every label is relevant, with and without sample weights.

* The discrete steps match exactly: the rank positions of
  ``argsort(argsort(preds))`` (stable, ``-0.0`` level with ``+0.0``, every NaN
  last), the ``>=`` rank counts behind LRAP, and each row's coverage.
* Each row's score is one division of exact integers (coverage, the
  ranking loss) or a float32 sum of ratios (LRAP); the batch sums and the
  weighted ones add in another order: ``rtol=1e-6``.  NaN compares as NaN.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.functional as jf
import metrics_tpu_torch as mt
import metrics_tpu_torch.functional as tf
from metrics_tpu.functional.classification import ranking as jr
from metrics_tpu_torch.functional.classification import ranking as tr

EAGER = {"jit_update": False, "jit_compute": False}
N, L = 40, 7
RTOL = 1e-6
NAMES = ["coverage_error", "label_ranking_average_precision", "label_ranking_loss"]
MODULES = {"coverage_error": "CoverageError", "label_ranking_average_precision": "LabelRankingAveragePrecision",
           "label_ranking_loss": "LabelRankingLoss"}


def _inputs(case: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    preds = (rng.integers(-4, 5, (N, L)) / 4).astype(np.float32)
    target = rng.integers(0, 2, (N, L))
    target[0] = 0  # no relevant label
    target[1] = 1  # every label relevant
    if case in ("specials", "nan"):
        flat = preds.reshape(-1)
        flat[rng.choice(flat.size, 12, replace=False)] = -0.0
        flat[rng.choice(flat.size, 12, replace=False)] = 0.0
        flat[rng.choice(flat.size, 4, replace=False)] = np.inf
        flat[rng.choice(flat.size, 4, replace=False)] = -np.inf
    if case == "nan":  # NaN of either sign
        flat[rng.choice(flat.size, 4, replace=False)] = np.nan
        flat[rng.choice(flat.size, 3, replace=False)] = np.copysign(np.nan, -1.0)
    if case == "random":
        preds = rng.random((N, L)).astype(np.float32)
    return preds, target


def _weights(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed + 100).random(N).astype(np.float32) + 0.5


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_close(port, ref, rtol=RTOL) -> None:
    got, want = _np(port), _np(ref)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0, equal_nan=True)


CASES = ["ties", "specials", "nan", "random"]


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", NAMES)
def test_functionals_match_jax(name, case, weighted):
    preds, target = _inputs(case)
    weight = _weights() if weighted else None
    ref = getattr(jf, name)(jnp.asarray(preds), jnp.asarray(target),
                            sample_weight=None if weight is None else jnp.asarray(weight))
    got = getattr(tf, name)(torch.from_numpy(preds), torch.from_numpy(target),
                            sample_weight=None if weight is None else torch.from_numpy(weight))
    assert_close(got, ref)
    ref_parts = getattr(jr, f"_{name}_update")(jnp.asarray(preds), jnp.asarray(target),
                                              None if weight is None else jnp.asarray(weight))
    parts = getattr(tr, f"_{name}_update")(torch.from_numpy(preds), torch.from_numpy(target),
                                           None if weight is None else torch.from_numpy(weight))
    assert parts[1] == ref_parts[1] == N
    assert_close(parts[0], ref_parts[0])
    if weighted:
        assert_close(parts[2], ref_parts[2])


@pytest.mark.parametrize("case", CASES)
def test_rank_positions_equal_jnp_argsort_twice(case):
    preds, _ = _inputs(case, seed=1)
    want = np.asarray(jnp.argsort(jnp.argsort(jnp.asarray(preds), axis=1), axis=1))
    np.testing.assert_array_equal(tr._rank_inverse(torch.from_numpy(preds)).numpy(), want)


def test_argsort_order_of_the_special_values():
    """Stable and ascending, ``-0.0`` level with ``+0.0``, every NaN last whatever its sign."""
    x = np.array([np.nan, 1.0, -0.0, np.inf, 0.0, np.copysign(np.nan, -1.0), -np.inf, 0.0], np.float32)[None]
    want = np.asarray(jnp.argsort(jnp.argsort(jnp.asarray(x), axis=1), axis=1))
    np.testing.assert_array_equal(tr._rank_inverse(torch.from_numpy(x)).numpy(), want)
    np.testing.assert_array_equal(want, [[6, 4, 1, 5, 2, 7, 0, 3]])


@pytest.mark.parametrize("case", CASES)
def test_lrap_rank_counts_and_coverage_per_row_equal_jax(case):
    preds, target = _inputs(case, seed=2)
    p = jnp.asarray(preds)
    ge = p[:, None, :] >= p[:, :, None]
    relevant = jnp.asarray(target) == 1
    rank_all, rank_rel = tr._lrap_ranks(torch.from_numpy(preds), torch.from_numpy(target) == 1)
    np.testing.assert_array_equal(rank_all.numpy(), np.asarray(jnp.sum(ge, axis=2).astype(jnp.float32)))
    np.testing.assert_array_equal(rank_rel.numpy(), np.asarray(jnp.sum(ge & relevant[:, None, :], axis=2).astype(jnp.float32)))
    big = jnp.abs(jnp.min(p)) + 10
    preds_min = jnp.min(p + jnp.where(jnp.asarray(target) == 0, big, 0.0), axis=1)
    want = np.asarray(jnp.sum(p >= preds_min[:, None], axis=1).astype(jnp.float32))
    np.testing.assert_array_equal(tr._coverage_per_sample(torch.from_numpy(preds), torch.from_numpy(target)).numpy(), want)


def test_lrap_in_row_chunks_equals_one_chunk():
    preds, target = _inputs("nan", seed=3)
    relevant = torch.from_numpy(target) == 1
    whole = tr._lrap_ranks(torch.from_numpy(preds), relevant)
    for chunk in (L * L, 3 * L * L, 1):  # one row, three rows, and below one row
        for a, b in zip(tr._lrap_ranks(torch.from_numpy(preds), relevant, chunk_elements=chunk), whole):
            assert torch.equal(a, b)


def test_rejects_what_jax_rejects():
    preds, target = _inputs("ties")
    bad = [(preds[0], target[0], None), (preds, target[:, :3], None), (preds, target, np.ones(N - 1, np.float32)),
           (preds, target, np.ones((N, 1), np.float32))]
    for name in NAMES:
        for p, t, w in bad:
            with pytest.raises(ValueError):
                getattr(jf, name)(jnp.asarray(p), jnp.asarray(t), None if w is None else jnp.asarray(w))
            with pytest.raises(ValueError):
                getattr(tf, name)(torch.from_numpy(p), torch.from_numpy(t), None if w is None else torch.from_numpy(w))


def test_zero_total_weight_falls_back_to_the_sample_count_like_jax():
    preds, target = _inputs("ties", seed=4)
    weight = np.zeros(N, np.float32)
    for name in NAMES:
        ref = getattr(jf, name)(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(weight))
        got = getattr(tf, name)(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(weight))
        assert_close(got, ref)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("name", NAMES)
def test_modules_stream_like_jax(name, weighted):
    ref = getattr(jm, MODULES[name])(**EAGER)
    port = getattr(mt, MODULES[name])(device="cpu")
    for seed, case in enumerate(("ties", "specials", "random")):
        preds, target = _inputs(case, seed=10 + seed)
        kwargs_ref, kwargs_port = {}, {}
        if weighted:
            kwargs_ref["sample_weight"] = jnp.asarray(_weights(seed))
            kwargs_port["sample_weight"] = torch.from_numpy(_weights(seed))
        assert_close(port(torch.from_numpy(preds), torch.from_numpy(target), **kwargs_port),
                     ref(jnp.asarray(preds), jnp.asarray(target), **kwargs_ref))
    assert port.measure.dtype == torch.float32 and port.weight.dtype == torch.float32
    assert port.total.dtype == torch.int32 and int(port.total) == int(ref.total) == 3 * N
    for state in ("measure", "weight"):
        assert_close(getattr(port, state), getattr(ref, state))
    if not weighted:  # the weight grows by the sample count
        assert float(port.weight) == 3 * N
    assert_close(port.compute(), ref.compute())


def _ranking_collection(pkg, **kwargs):
    return pkg.MetricCollection(
        {"coverage": pkg.CoverageError(**kwargs), "lrap": pkg.LabelRankingAveragePrecision(**kwargs),
         "lrl": pkg.LabelRankingLoss(**kwargs)},
        **({"device": "cpu"} if "device" in kwargs else {}),
    )


def test_collection_compute_groups_equal_the_jax_collection():
    ref, port = _ranking_collection(jm, **EAGER), _ranking_collection(mt, device="cpu")
    for seed in (20, 21):
        preds, target = _inputs("random", seed)
        ref.update(jnp.asarray(preds), jnp.asarray(target), sample_weight=jnp.asarray(_weights(seed)))
        port.update(torch.from_numpy(preds), torch.from_numpy(target), sample_weight=torch.from_numpy(_weights(seed)))
    assert [sorted(g) for g in port.compute_groups.values()] == [sorted(g) for g in ref.compute_groups.values()]
    got, want = port.compute(), ref.compute()
    for key in want:
        assert_close(got[key], want[key])
