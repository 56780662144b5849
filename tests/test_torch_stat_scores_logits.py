"""The logits route of the stat-scores engine against the JAX package, on the CPU.

Float logits ``(N, C)`` and integer labels ``(N,)`` go through the JAX
package's ``_stat_scores_update`` (top-1 mask, one-hot, counts) and through
the port's :func:`fused_stat_scores_logits_plain` and its routed
``_stat_scores_update``.  Counts must match bitwise.  Logits lie on a grid of
eighths in ``[-2, 2]``, so ties abound and bfloat16 and float16 hold them
exactly; the 16-bit bits are made by JAX and handed to torch unchanged.  Rows
of NaN, -NaN, signed zeros and infinities test the order of ``lax.top_k``.
Module metrics compare states bitwise and ``compute()`` to ``rtol=1e-6,
atol=1e-7`` (float32 on both sides; torch and XLA may sum per-class scores in
another order).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu_torch as mt
from metrics_tpu.functional.classification.stat_scores import _stat_scores_update as jax_update
from metrics_tpu.utils.data import select_topk as jax_select_topk
from metrics_tpu_torch.functional.classification.stat_scores import _stat_scores_update
from metrics_tpu_torch.ops import stat_scores as ops
from metrics_tpu_torch.utils.data import select_topk

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}
NEG_NAN = np.copysign(np.float32(np.nan), -1.0)
PAYLOAD_NAN = np.array([0x7FC00001], np.uint32).view(np.float32)[0]
SPECIAL_ROWS = np.array(
    [
        [-np.inf] * 4,
        [1.0, np.nan, 3.0, np.nan],
        [-0.0, 0.0, -0.0, 0.0],
        [0.0, -0.0, 0.0, -0.0],
        [NEG_NAN, 1.0, 2.0, -np.inf],
        [-np.inf, NEG_NAN, -1.0, -1.0],
        [np.nan, PAYLOAD_NAN, 0.0, 0.0],
        [np.inf, 1.0, np.inf, np.nan],
        [2.0, 1.0, 2.0, 1.0],
        [NEG_NAN, NEG_NAN, -np.inf, -np.inf],
    ],
    np.float32,
)


def logits_pair(x: np.ndarray, dtype: str):
    """The same logits for both packages: JAX rounds to the dtype, torch takes its bits."""
    jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(x, jdt)
    if tdt == torch.float32:
        return j, torch.from_numpy(x.copy())
    return j, torch.from_numpy(np.asarray(j).view(np.int16).copy()).view(tdt)


def make_case(n, c, seed, out_of_range=False):
    rng = np.random.default_rng(seed)
    x = (rng.integers(-16, 17, (n, c)) / 8).astype(np.float32)
    labels = rng.integers(0, c, n)
    if c == 4 and n >= len(SPECIAL_ROWS):
        x[: len(SPECIAL_ROWS)] = SPECIAL_ROWS
    if out_of_range and n >= 3:
        labels[:3] = (c, -1, c + 7)
    return x, labels


def assert_counts_equal(got, expected):
    assert len(got) == len(expected) == 4
    for g, e in zip(got, expected):
        e = np.asarray(e)
        assert g.dtype == torch.int32 and g.shape == e.shape
        np.testing.assert_array_equal(g.numpy(), e)


@functools.lru_cache(maxsize=None)
def jax_counts(n, c, seed, out_of_range, dtype, reduce):
    """JAX's counts; labels are int32 there either way (x64 is off), so int32 and int64 share them."""
    x, labels = make_case(n, c, seed, out_of_range)
    out = jax_update(logits_pair(x, dtype)[0], jnp.asarray(labels), reduce=reduce, num_classes=c,
                     validate_args=not out_of_range)
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", [1, 2, 3])
def test_select_topk_orders_like_lax_top_k(k, dtype):
    # -0.0 below +0.0, a NaN's sign deciding its end, ties to the lower index:
    # torch.argmax and torch.topk gave other answers on these rows
    j, t = logits_pair(SPECIAL_ROWS, dtype)
    np.testing.assert_array_equal(select_topk(t, k).numpy(), np.asarray(jax_select_topk(j, k)))


CASES = [  # (n, c, seed, out_of_range, dtypes)
    (37, 9, 0, False, ("float32", "bfloat16", "float16")),
    (37, 9, 1, True, ("float32",)),
    (1024, 1000, 2, False, ("float32",)),
    (3, 5, 3, False, ("float32",)),
    (0, 4, 4, True, ("float32",)),
    (70, 1030, 5, True, ("float32",)),
    (16, 1, 6, False, ("float32",)),
    (24, 4, 7, True, ("float32", "bfloat16", "float16")),  # the special rows
]


@pytest.mark.parametrize("reduce", ["macro", "micro"])
@pytest.mark.parametrize("label_dtype", [np.int64, np.int32])
@pytest.mark.parametrize(
    "n,c,seed,out_of_range,dtype",
    [(n, c, s, o, d) for n, c, s, o, dtypes in CASES for d in dtypes],
)
def test_logits_route_matches_jax(n, c, seed, out_of_range, dtype, label_dtype, reduce):
    x, labels = make_case(n, c, seed, out_of_range)
    logits, labels = logits_pair(x, dtype)[1], torch.from_numpy(labels.astype(label_dtype))
    expected = jax_counts(n, c, seed, out_of_range, dtype, reduce)
    routed = _stat_scores_update(logits, labels, reduce=reduce, num_classes=c, validate_args=not out_of_range)
    assert_counts_equal(routed, expected)
    if reduce == "macro":
        assert_counts_equal(ops.fused_stat_scores_logits_plain(logits, labels), expected)
        assert_counts_equal(ops.fused_stat_scores_logits(logits, labels), expected)


def assert_same(port, ref) -> None:
    ref = np.asarray(ref)
    got = port.detach().cpu().numpy()
    assert got.shape == ref.shape
    if np.issubdtype(ref.dtype, np.integer):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    else:
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7, equal_nan=True)


METRICS = {
    "accuracy_micro": lambda pkg, **kw: pkg.Accuracy(num_classes=4, **kw),
    "accuracy_macro": lambda pkg, **kw: pkg.Accuracy(num_classes=4, average="macro", **kw),
    "f1_macro": lambda pkg, **kw: pkg.F1Score(num_classes=4, average="macro", **kw),
    "precision_macro": lambda pkg, **kw: pkg.Precision(num_classes=4, average="macro", **kw),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(METRICS))
def test_module_metrics_on_logits_match_jax(name, dtype):
    # eager: the same counts and scores, without a jit compile per instance
    ref, port = METRICS[name](jm, jit_update=False, jit_compute=False), METRICS[name](mt, device="cpu")
    for seed, size in enumerate((48, 48, 21)):
        x, labels = make_case(size, 4, seed + 10)
        j, t = logits_pair(x, dtype)
        ref.update(j, jnp.asarray(labels))
        port.update(t, torch.from_numpy(labels))
    for state in ("tp", "fp", "tn", "fn"):
        assert_same(getattr(port, state), getattr(ref, state))
    assert_same(port.compute(), ref.compute())
