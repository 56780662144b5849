"""The port's pairwise functionals against the JAX package, on the CPU.

The same numpy inputs (made from a seed) go through ``metrics_tpu`` and
``metrics_tpu_torch``.  With ``U = 2**-24`` and ``d`` the row width:

* On rows of multiples of 1/8 every product, norm and sum is exact in
  float32: linear, euclidean (the Gram form, then a correctly rounded sqrt)
  and manhattan match bitwise.
* On random rows a dot product is a ``d``-term float32 sum added in another
  order (XLA's dot and torch's matmul): it differs by at most
  ``d * U * sum(|x_k * y_k|)``, computed per entry in float64.  Euclidean
  distances cancel (``||x||² + ||y||² - 2 x·y``), so their squares are held to
  ``(d + 4) * U * (||x||² + ||y||² + 2 sum|x_k y_k|)`` absolute and the
  distances to the square root of that; cosine (unit rows) to ``(d + 8) * U``;
  manhattan (terms of one sign) to ``d * U`` relative.
* Manhattan in row chunks equals the unchunked form bitwise: each distance is
  the same sum over its ``d`` terms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional as jf
import metrics_tpu_torch.functional as tf
from metrics_tpu_torch.functional.pairwise.manhattan import _pairwise_manhattan_distance_compute

N, M, D = 12, 7, 16
U = 2.0**-24
NAMES = ("pairwise_linear_similarity", "pairwise_cosine_similarity", "pairwise_euclidean_distance", "pairwise_manhattan_distance")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rows(n: int, seed: int, dyadic: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.integers(-16, 17, (n, D)) / 8 if dyadic else rng.standard_normal((n, D))).astype(np.float32)


def _bound(name: str, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """The largest float32 difference two sum orders allow, per entry of the ``[N, M]`` matrix."""
    x, y = x.astype(np.float64), y.astype(np.float64)
    abs_dot = np.abs(x) @ np.abs(y).T
    if name == "pairwise_linear_similarity":
        return D * U * abs_dot
    if name == "pairwise_cosine_similarity":
        return np.full(abs_dot.shape, (D + 8) * U)
    if name == "pairwise_euclidean_distance":
        sq = (D + 4) * U * ((x * x).sum(1)[:, None] + (y * y).sum(1)[None, :] + 2 * abs_dot)
        return np.sqrt(sq)
    return D * U * np.abs(x[:, None, :] - y[None, :, :]).sum(-1)


def _compare(name, got, want, bound, reduction, exact):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    if exact:
        assert got.tobytes() == want.tobytes()
        return
    if reduction == "sum":
        bound = bound.sum(-1) + M * U * np.abs(want)
    elif reduction == "mean":
        bound = bound.mean(-1) + M * U * np.abs(want)
    assert np.all(np.abs(got.astype(np.float64) - want) <= bound), np.max(np.abs(got - want) - bound)


@pytest.mark.parametrize("dyadic", [True, False], ids=["eighths", "random"])
@pytest.mark.parametrize("reduction", [None, "mean", "sum"], ids=str)
@pytest.mark.parametrize("with_y", [True, False], ids=["x_y", "x_only"])
@pytest.mark.parametrize("name", NAMES)
def test_functionals_match_jax(name, with_y, reduction, dyadic):
    x = _rows(N, 1, dyadic)
    y = _rows(M, 2, dyadic) if with_y else None
    args_t = (torch.from_numpy(x), None if y is None else torch.from_numpy(y))
    args_j = (jnp.asarray(x), None if y is None else jnp.asarray(y))
    got = getattr(tf, name)(*args_t, reduction=reduction)
    want = getattr(jf, name)(*args_j, reduction=reduction)
    # a sum of eighths is exact, a sum of square roots is not, and a mean may multiply by 1 / M
    exact = dyadic and reduction is None if name == "pairwise_euclidean_distance" else (
        dyadic and name != "pairwise_cosine_similarity" and reduction != "mean")
    bound = _bound(name, x, x if y is None else y)
    if y is None:
        np.fill_diagonal(bound, 0.0)  # the zeroed diagonal
    _compare(name, got, want, bound, reduction, exact)


@pytest.mark.parametrize("zero_diagonal", [None, True, False], ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_zero_diagonal_matches_jax(name, zero_diagonal):
    """Only ``y=None`` zeroes the diagonal by default; an explicit flag zeroes the first ``min(N, M)`` entries of it."""
    x, y = _rows(N, 3, True), _rows(M, 4, True)
    for second in (None, y):
        got = getattr(tf, name)(torch.from_numpy(x), None if second is None else torch.from_numpy(second), zero_diagonal=zero_diagonal)
        want = getattr(jf, name)(jnp.asarray(x), None if second is None else jnp.asarray(second), zero_diagonal=zero_diagonal)
        bound = _bound(name, x, x if second is None else second)
        exact = name != "pairwise_cosine_similarity"
        _compare(name, got, want, bound, None, exact)
        if zero_diagonal if zero_diagonal is not None else second is None:
            assert np.all(np.diagonal(_np(got)) == 0)


@pytest.mark.parametrize("budget", [1, 7 * D, 5 * M * D, 1 << 24], ids=["one_row", "part_row", "five_rows", "default"])
def test_manhattan_in_row_chunks_equals_the_unchunked_form(budget):
    x, y = _rows(N, 5, False), _rows(M, 6, False)
    whole = torch.from_numpy(np.abs(x[:, None, :] - y[None, :, :]).sum(-1, dtype=np.float32))  # one (N, M, D) difference
    for second in (torch.from_numpy(y), None):
        got = _pairwise_manhattan_distance_compute(torch.from_numpy(x), second, chunk_elements=budget)
        want = whole if second is not None else torch.from_numpy(np.abs(x[:, None, :] - x[None]).sum(-1, dtype=np.float32)).fill_diagonal_(0)
        unchunked = torch.sum((torch.from_numpy(x)[:, None, :] - (torch.from_numpy(x) if second is None else second)[None]).abs(), -1)
        if second is None:
            unchunked.fill_diagonal_(0)
        assert torch.equal(got, unchunked)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=D * U)


def test_inputs_of_other_dtypes_are_float32_like_jax():
    rng = np.random.default_rng(7)
    x = rng.integers(-3, 4, (N, D)).astype(np.int32)
    for name in NAMES:
        got = getattr(tf, name)(torch.from_numpy(x))
        want = getattr(jf, name)(jnp.asarray(x))
        _compare(name, got, want, _bound(name, x.astype(np.float32), x.astype(np.float32)), None, name != "pairwise_cosine_similarity")
    xd = rng.standard_normal((N, D))  # float64 rounds to float32 at the boundary
    got = tf.pairwise_linear_similarity(torch.from_numpy(xd))
    want = jf.pairwise_linear_similarity(jnp.asarray(xd.astype(np.float32)))
    bound = _bound("pairwise_linear_similarity", xd.astype(np.float32), xd.astype(np.float32))
    np.fill_diagonal(bound, 0.0)
    _compare("pairwise_linear_similarity", got, want, bound, None, False)


def test_errors_match_jax():
    x = np.ones((N, D), np.float32)
    for name in NAMES:
        for args, kwargs in (((x[0],), {}), ((x, np.ones((M, D + 1), np.float32)), {}), ((x, np.ones(D, np.float32)), {}),
                             ((x,), {"reduction": "max"})):
            with pytest.raises(ValueError):
                getattr(jf, name)(*map(jnp.asarray, args), **kwargs)
            with pytest.raises(ValueError):
                getattr(tf, name)(*map(torch.from_numpy, args), **kwargs)


def test_zero_rows_give_zero_cosine_like_jax():
    """Norms clamp at 1e-30: a zero row has zero similarity, not NaN."""
    x = _rows(N, 8, True)
    x[3] = 0
    got = tf.pairwise_cosine_similarity(torch.from_numpy(x))
    want = jf.pairwise_cosine_similarity(jnp.asarray(x))
    assert not torch.isnan(got).any() and torch.all(got[3] == 0)
    _compare("pairwise_cosine_similarity", got, want, np.full((N, N), (D + 8) * U), None, False)


def test_every_pairwise_name_of_the_jax_package_is_exported():
    import metrics_tpu.functional.pairwise as jfp
    import metrics_tpu_torch as mt
    import metrics_tpu_torch.functional.pairwise as tfp

    assert set(jfp.__all__) <= set(tfp.__all__) <= set(tf.__all__) <= set(mt.__all__)
    for name in jfp.__all__:
        assert getattr(mt, name) is getattr(tf, name) is getattr(tfp, name)
