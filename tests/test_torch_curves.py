"""The port's exact curve metrics against the JAX package, on the CPU.

The same numpy inputs (made from a seed) go through ``metrics_tpu`` and
``metrics_tpu_torch``: ``precision_recall_curve``, ``roc``, ``auc``,
``auroc`` and ``average_precision`` as functionals, and their modules
streamed over three batches.  Scores are multiples of 1/8, so most rows
tie; some cases add NaN and signed-zero scores, and some sample weights.

* Curves (precision, recall, fpr, tpr, thresholds) and the cumulative
  counts of ``_binary_clf_curve`` compare bitwise: the same order of rows,
  float64 ratios rounded once to float32.  NaN compares equal to NaN.
* Areas (AUROC, AP, AUC) are float32 sums over the curve, which XLA and
  torch add in another order: ``rtol=1e-6``.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.functional as jf
import metrics_tpu_torch as mt
import metrics_tpu_torch.functional as tf
from metrics_tpu.functional.classification.precision_recall_curve import _binary_clf_curve as jax_clf_curve
from metrics_tpu_torch.functional.classification.precision_recall_curve import _binary_clf_curve

N, C, X = 96, 5, 3
EAGER = {"jit_update": False, "jit_compute": False}
AREA_RTOL = 1e-6


def _eighths(rng, shape):
    return (rng.integers(0, 9, shape) / 8).astype(np.float32)


def _inputs(case: str, seed: int = 0, specials: bool = False):
    """(preds, target, num_classes) for one input case."""
    rng = np.random.default_rng(seed)
    if case == "binary":
        preds, target, classes = _eighths(rng, N), rng.integers(0, 2, N), 1
    elif case == "multiclass":
        preds, target, classes = _eighths(rng, (N, C)), rng.integers(0, C, N), C
    elif case == "multilabel":
        preds, target, classes = _eighths(rng, (N, C)), rng.integers(0, 2, (N, C)), C
    elif case == "mdmc":
        preds, target, classes = _eighths(rng, (N, C, X)), rng.integers(0, C, (N, X)), C
    else:
        raise ValueError(case)
    if specials:
        flat = preds.reshape(-1)
        flat[[3, 11, 40]] = np.nan
        flat[[5, 17, 23]] = -0.0
        flat[[6, 18]] = 0.0
    return preds, target, classes


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_bitwise(port, ref) -> None:
    """Same dtype, shape and bits (NaN equal to NaN, -0.0 not equal to +0.0)."""
    if isinstance(ref, (list, tuple)):
        assert isinstance(port, (list, tuple)) and len(port) == len(ref)
        for p, r in zip(port, ref):
            assert_bitwise(p, r)
        return
    got, want = _np(port), _np(ref)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        width = {2: np.int16, 4: np.int32, 8: np.int64}[want.dtype.itemsize]
        np.testing.assert_array_equal(got[~nan].view(width), want[~nan].view(width))
    else:
        np.testing.assert_array_equal(got, want)


def assert_area(port, ref) -> None:
    if isinstance(ref, (list, tuple)):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            assert_area(p, r)
        return
    got, want = _np(port), _np(ref)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=AREA_RTOL, atol=0, equal_nan=True)


def _both(jax_fn, torch_fn, preds, target, **kwargs):
    """The JAX package's result and the port's, or the exception type both raise."""
    try:
        ref = jax_fn(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    except (ValueError, RuntimeError, IndexError) as err:
        with pytest.raises(type(err)):
            torch_fn(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
        return None, None
    return torch_fn(torch.from_numpy(preds), torch.from_numpy(target), **kwargs), ref


# ------------------------------------------------------------------ curves
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "sample_weights"])
@pytest.mark.parametrize("specials", [False, True], ids=["eighths", "nan_and_signed_zeros"])
def test_binary_clf_curve_counts_are_bitwise(specials, weighted):
    preds, target, _ = _inputs("binary", seed=1, specials=specials)
    weights = np.random.default_rng(2).random(N) if weighted else None
    ref = jax_clf_curve(preds, target, weights, pos_label=1)
    got = _binary_clf_curve(torch.from_numpy(preds), torch.from_numpy(target), weights, pos_label=1)
    assert_bitwise(got, ref)


def test_sort_order_is_numpys_stable_argsort_reversed():
    from metrics_tpu_torch.functional.classification.precision_recall_curve import _descending_order

    x = np.array([0.3, 0.3, -0.0, 0.0, np.nan, 0.7, np.nan, np.inf, -np.inf, np.inf], np.float32)
    x[6] = np.copysign(np.nan, -1.0)
    want = np.argsort(x, kind="stable")[::-1]
    np.testing.assert_array_equal(_descending_order(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("name", ["precision_recall_curve", "roc"])
@pytest.mark.parametrize("specials", [False, True], ids=["eighths", "nan_and_signed_zeros"])
@pytest.mark.parametrize("case", ["binary", "multiclass", "multilabel"])
def test_curve_functionals_are_bitwise(name, case, specials):
    preds, target, classes = _inputs(case, seed=3, specials=specials)
    kwargs = {"pos_label": 1} if case == "binary" else {"num_classes": classes}
    got, ref = _both(getattr(jf, name), getattr(tf, name), preds, target, **kwargs)
    assert ref is not None
    assert_bitwise(got, ref)


@pytest.mark.parametrize("name", ["precision_recall_curve", "roc"])
@pytest.mark.parametrize("case", ["binary", "multiclass"])
def test_curve_functionals_with_sample_weights(name, case):
    preds, target, classes = _inputs(case, seed=4)
    weights = np.random.default_rng(5).random(N)
    kwargs = {"pos_label": 1} if case == "binary" else {"num_classes": classes}
    got, ref = _both(getattr(jf, name), getattr(tf, name), preds, target, sample_weights=weights, **kwargs)
    assert_bitwise(got, ref)


def test_binary_curves_with_another_pos_label():
    preds, target, _ = _inputs("binary", seed=6)
    for name in ("precision_recall_curve", "roc"):
        got, ref = _both(getattr(jf, name), getattr(tf, name), preds, target, pos_label=0)
        assert_bitwise(got, ref)


# -------------------------------------------------------------------- auc
@pytest.mark.parametrize("reorder", [False, True])
@pytest.mark.parametrize("order", ["increasing", "decreasing", "shuffled"])
def test_auc_matches_jax(order, reorder):
    rng = np.random.default_rng(7)
    x = np.sort(rng.random(40).astype(np.float32))
    y = rng.random(40).astype(np.float32)
    if order == "decreasing":
        x = x[::-1].copy()
    elif order == "shuffled":
        x = rng.permutation(x)
    got, ref = _both(jf.auc, tf.auc, x, y, reorder=reorder)
    if ref is None:
        assert order == "shuffled" and not reorder
        return
    assert_area(got, ref)


# ------------------------------------------------------------------ auroc
@pytest.mark.parametrize("specials", [False, True], ids=["eighths", "nan_and_signed_zeros"])
@pytest.mark.parametrize("average", ["macro", "weighted", "none", "micro", None])
@pytest.mark.parametrize("case", ["binary", "multiclass", "multilabel", "mdmc"])
def test_auroc_matches_jax(case, average, specials):
    preds, target, classes = _inputs(case, seed=8, specials=specials)
    kwargs = {"pos_label": 1} if case == "binary" else {"num_classes": classes}
    got, ref = _both(jf.auroc, tf.auroc, preds, target, average=average, **kwargs)
    if ref is not None:
        assert_area(got, ref)


@pytest.mark.parametrize("max_fpr", [0.1, 0.35, 0.5, 0.8, 1.0])
def test_partial_auroc_matches_jax(max_fpr):
    preds, target, _ = _inputs("binary", seed=9)
    got, ref = _both(jf.auroc, tf.auroc, preds, target, pos_label=1, max_fpr=max_fpr)
    assert_area(got, ref)


def test_weighted_auroc_omits_a_class_without_observations():
    preds, target, classes = _inputs("multiclass", seed=10)
    target = np.where(target == 2, 0, target)  # class 2 never occurs
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got, ref = _both(jf.auroc, tf.auroc, preds, target, num_classes=classes, average="weighted")
    assert sum("Class 2 had 0 observations" in str(w.message) for w in seen) == 2  # one from each package
    assert_area(got, ref)


def test_auroc_with_sample_weights_matches_jax():
    preds, target, classes = _inputs("multiclass", seed=11)
    weights = np.random.default_rng(12).random(N)
    got, ref = _both(jf.auroc, tf.auroc, preds, target, num_classes=classes, sample_weights=weights)
    assert_area(got, ref)


# ------------------------------------------------------ average precision
@pytest.mark.parametrize("specials", [False, True], ids=["eighths", "nan_and_signed_zeros"])
@pytest.mark.parametrize("average", ["macro", "weighted", "none", "micro"])
@pytest.mark.parametrize("case", ["binary", "multiclass", "multilabel"])
def test_average_precision_matches_jax(case, average, specials):
    preds, target, classes = _inputs(case, seed=13, specials=specials)
    kwargs = {"pos_label": 1} if case == "binary" else {"num_classes": classes}
    got, ref = _both(jf.average_precision, tf.average_precision, preds, target, average=average, **kwargs)
    if ref is not None:
        assert_area(got, ref)


@pytest.mark.parametrize("average", ["macro", "weighted", "none"])
def test_average_precision_of_a_class_without_positives_is_nan(average):
    preds, target, classes = _inputs("multilabel", seed=14)
    target[:, 3] = 0  # class 3: recall 0/0
    got, ref = _both(jf.average_precision, tf.average_precision, preds, target, num_classes=classes, average=average)
    assert_area(got, ref)
    if average == "none":
        assert np.isnan(_np(got[3]))


# ---------------------------------------------------------------- modules
def _batches(preds, target):
    cuts = [0, N // 3, 2 * N // 3, N]
    return [(preds[a:b], target[a:b]) for a, b in zip(cuts, cuts[1:])]


def _streamed(jax_metric, port_metric, preds, target):
    for p, t in _batches(preds, target):
        jax_metric.update(jnp.asarray(p), jnp.asarray(t))
        port_metric.update(torch.from_numpy(p), torch.from_numpy(t))
    return port_metric.compute(), jax_metric.compute()


MODULE_CASES = {
    "PrecisionRecallCurve": ("binary", {"pos_label": 1}),
    "PrecisionRecallCurve_multiclass": ("multiclass", {"num_classes": C}),
    "ROC": ("binary", {"pos_label": 1}),
    "ROC_multilabel": ("multilabel", {"num_classes": C}),
}


@pytest.mark.parametrize("specials", [False, True], ids=["eighths", "nan_and_signed_zeros"])
@pytest.mark.parametrize("name", MODULE_CASES)
def test_curve_modules_streamed_are_bitwise(name, specials):
    case, kwargs = MODULE_CASES[name]
    cls = name.split("_")[0]
    preds, target, _ = _inputs(case, seed=15, specials=specials)
    got, ref = _streamed(getattr(jm, cls)(**kwargs, **EAGER), getattr(mt, cls)(**kwargs, device="cpu"), preds, target)
    assert_bitwise(got, ref)


@pytest.mark.parametrize("average", ["macro", "weighted", "none"])
@pytest.mark.parametrize("case", ["binary", "multiclass", "multilabel", "mdmc"])
def test_auroc_module_streamed_matches_jax(case, average):
    preds, target, classes = _inputs(case, seed=16)
    kwargs = {"pos_label": 1} if case == "binary" else {"num_classes": classes}
    average = None if average == "none" else average
    got, ref = _streamed(jm.AUROC(average=average, **kwargs, **EAGER), mt.AUROC(average=average, **kwargs, device="cpu"),
                         preds, target)
    assert_area(got, ref)


def test_auroc_module_with_max_fpr_matches_jax():
    preds, target, _ = _inputs("binary", seed=17)
    got, ref = _streamed(jm.AUROC(pos_label=1, max_fpr=0.3, **EAGER), mt.AUROC(pos_label=1, max_fpr=0.3, device="cpu"),
                         preds, target)
    assert_area(got, ref)


def test_auroc_module_rejects_a_change_of_mode_as_jax_does():
    """Binary float scores, then integer labels above 1 (multi-class): both packages raise."""
    first = (np.linspace(0, 1, 8, dtype=np.float32), np.array([0, 1] * 4))
    second = (np.array([0, 2, 1, 3] * 2), np.array([0, 1, 2, 3] * 2))
    for pkg, kwargs, as_input in ((jm, EAGER, jnp.asarray), (mt, {"device": "cpu"}, torch.from_numpy)):
        metric = pkg.AUROC(**kwargs)
        metric.update(*map(as_input, first))
        with pytest.raises(ValueError, match="should be constant"):
            metric.update(*map(as_input, second))


@pytest.mark.parametrize("average", ["macro", "weighted", "none", "micro"])
@pytest.mark.parametrize("case", ["binary", "multiclass", "multilabel"])
def test_average_precision_module_streamed_matches_jax(case, average):
    preds, target, classes = _inputs(case, seed=18, specials=True)
    kwargs = {"pos_label": 1} if case == "binary" else {"num_classes": classes}
    try:
        ref_metric = jm.AveragePrecision(average=average, **kwargs, **EAGER)
        got, ref = _streamed(ref_metric, mt.AveragePrecision(average=average, **kwargs, device="cpu"), preds, target)
    except ValueError as err:
        with pytest.raises(type(err)):
            _streamed(jm.AveragePrecision(average=average, **kwargs, **EAGER),
                      mt.AveragePrecision(average=average, **kwargs, device="cpu"), preds, target)
        return
    assert_area(got, ref)


@pytest.mark.parametrize("reorder", [False, True])
def test_auc_module_streamed_matches_jax(reorder):
    rng = np.random.default_rng(19)
    x = np.sort(rng.random(N).astype(np.float32))
    if reorder:
        x = rng.permutation(x)
    y = rng.random(N).astype(np.float32)
    got, ref = _streamed(jm.AUC(reorder=reorder, **EAGER), mt.AUC(reorder=reorder, device="cpu"), x, y)
    assert_area(got, ref)
