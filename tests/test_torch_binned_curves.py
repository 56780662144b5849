"""The port's binned curve metrics against the JAX package, on the CPU.

* The thresholds equal ``jnp.linspace(0, 1.0, T)`` bit for bit (one ulp
  moves ``preds >= threshold`` decisions).
* The ``(C, T)`` float32 sums of true positives, false positives and false
  negatives equal the JAX package's bitwise: integer counts below 2**24.
* The chunked update equals one unchunked ``(N, C, T)`` comparison.
* Precision/recall curves are float32 from the same sums by the same
  operations: bitwise.  Binned AP and the recall at a fixed precision are
  sums over the curve, which XLA and torch add in another order:
  ``rtol=1e-6``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu_torch as mt
from metrics_tpu_torch.classification.binned_precision_recall import _binned_counts
from metrics_tpu_torch.utils.data import _linspace_thresholds
from tests.test_torch_curves import _np, assert_area, assert_bitwise

N, C = 200, 4
EAGER = {"jit_update": False, "jit_compute": False}
STATES = ("TPs", "FPs", "FNs")


@pytest.mark.parametrize("num", [1, 2, 7, 42, 48, 83, 100, 1000])
def test_thresholds_equal_jnp_linspace_bitwise(num):
    want = np.asarray(jnp.linspace(0, 1.0, num))
    got = mt.BinnedPrecisionRecallCurve(num_classes=1, thresholds=num, device="cpu").thresholds.numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(_linspace_thresholds(num).view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("num", [42, 48, 83])
def test_the_reciprocal_product_alone_misses_the_end_point(num):
    """``float32(1/(T-1)) * arange(T)`` is ``jnp.linspace`` but at its last point, 1.0, for these T."""
    product = np.float32(1 / (num - 1)) * np.arange(num, dtype=np.float32)
    assert product[-1] != 1.0
    np.testing.assert_array_equal(product[:-1], _linspace_thresholds(num)[:-1])


def _inputs(case: str, seed: int):
    rng = np.random.default_rng(seed)
    # scores on the threshold grid and between, so many sit exactly on a threshold
    if case == "binary":
        return (rng.integers(0, 21, N) / 20).astype(np.float32), rng.integers(0, 2, N), 1
    if case == "multiclass":
        return rng.random((N, C)).astype(np.float32), rng.integers(0, C, N), C
    preds = (rng.integers(0, 7, (N, C)) / 6).astype(np.float32)
    return preds, rng.integers(0, 2, (N, C)), C


def _streamed(name, case, seed, **kwargs):
    preds, target, classes = _inputs(case, seed)
    ref = getattr(jm, name)(num_classes=classes, **kwargs, **EAGER)
    port = getattr(mt, name)(num_classes=classes, **kwargs, device="cpu")
    for lo in range(0, N, 64):
        ref.update(jnp.asarray(preds[lo : lo + 64]), jnp.asarray(target[lo : lo + 64]))
        port.update(torch.from_numpy(preds[lo : lo + 64]), torch.from_numpy(target[lo : lo + 64]))
    return port, ref


CASES = ["binary", "multiclass", "multilabel"]


@pytest.mark.parametrize("thresholds", [7, 100, [0.9, 0.1, 0.5, 0.25]], ids=["T7", "T100", "list"])
@pytest.mark.parametrize("case", CASES)
def test_binned_curve_sums_and_curves_are_bitwise(case, thresholds):
    port, ref = _streamed("BinnedPrecisionRecallCurve", case, seed=1, thresholds=thresholds)
    for name in STATES:
        assert_bitwise(getattr(port, name), ref._state[name])
    assert_bitwise(port.compute(), ref.compute())


@pytest.mark.parametrize("thresholds", [7, 100])
@pytest.mark.parametrize("case", CASES)
def test_binned_average_precision_matches_jax(case, thresholds):
    port, ref = _streamed("BinnedAveragePrecision", case, seed=2, thresholds=thresholds)
    assert_area(port.compute(), ref.compute())


@pytest.mark.parametrize("min_precision", [0.0, 0.3, 0.6, 1.1])
@pytest.mark.parametrize("case", CASES)
def test_binned_recall_at_fixed_precision_matches_jax(case, min_precision):
    port, ref = _streamed("BinnedRecallAtFixedPrecision", case, seed=3, thresholds=7, min_precision=min_precision)
    got, want = port.compute(), ref.compute()
    assert_area(got[0], want[0])
    assert_bitwise(got[1], want[1])


@pytest.mark.parametrize("chunk", [1, 7, 64, 10**9], ids=["chunk1", "chunk7", "chunk64", "unchunked"])
def test_chunked_counts_equal_one_unchunked_comparison(chunk):
    preds, target, classes = _inputs("multiclass", seed=4)
    preds, target = torch.from_numpy(preds), torch.nn.functional.one_hot(torch.from_numpy(target), classes).bool()
    thresholds = torch.from_numpy(_linspace_thresholds(100))
    hit = preds[:, :, None] >= thresholds
    want = ((hit & target[..., None]).sum(0), (hit & ~target[..., None]).sum(0), (~hit & target[..., None]).sum(0))
    got = _binned_counts(preds, target, thresholds, chunk_elements=chunk * classes * 100)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_binned_states_sync_as_sums():
    port, _ = _streamed("BinnedAveragePrecision", "multiclass", seed=5, thresholds=7)
    assert all(port._reduce_fns[name] == "sum" and _np(getattr(port, name)).dtype == np.float32 for name in STATES)
