"""The port's JaccardIndex, MatthewsCorrCoef and CohenKappa against the JAX package, on the CPU.

The same numpy inputs (made from a seed) go through ``metrics_tpu`` and
``metrics_tpu_torch``.  The ``(C, C)`` int32 confusion matrix they all
stream must match bitwise.  The scores are float32 on both sides:

* Jaccard to ``rtol=1e-6, atol=1e-7``: each class's IoU is one division, and
  the averages sum the classes in another order.
* MCC to ``atol = 2 * s**2 * 2**-24 / sqrt(denom)`` (``s`` the sample count):
  its numerator ``c * s - sum(tk * pk)`` cancels, and each float32 term near
  ``s**2`` carries up to ``s**2 * 2**-24`` of rounding, which the two
  packages add in another order (XLA also divides by ``rsqrt``).  The
  largest seen over a grid of random matrices was 0.46 of that unit.
* Kappa to ``atol = 4 * ceil(log2(C * C)) * 2**-24 * |1 - kappa|``: kappa is
  ``1 - k``, ``k`` a quotient of two float32 sums of ``C * C`` products that the
  two packages add in another order.  The largest seen was 13.8 units of
  ``2**-24 * |k|`` at ``C = 40``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.functional as jf
import metrics_tpu_torch as mt
import metrics_tpu_torch.functional as tf
from metrics_tpu.functional.classification.cohen_kappa import _cohen_kappa_compute as jax_kappa
from metrics_tpu.functional.classification.jaccard import _jaccard_from_confmat as jax_jaccard
from metrics_tpu.functional.classification.matthews_corrcoef import _matthews_corrcoef_compute as jax_mcc
from metrics_tpu_torch.functional.classification.cohen_kappa import _cohen_kappa_compute
from metrics_tpu_torch.functional.classification.jaccard import _jaccard_from_confmat
from metrics_tpu_torch.functional.classification.matthews_corrcoef import _matthews_corrcoef_compute
from tests.test_torch_classification import _case_inputs, assert_same

EAGER = {"jit_update": False, "jit_compute": False}
U = 2.0**-24
CASES = ["binary_probs", "multiclass_labels", "multiclass_probs"]
AVERAGES = ["micro", "macro", "weighted", "none", None]
WEIGHTS = [None, "linear", "quadratic"]


def assert_mcc(port, ref, confmat: np.ndarray) -> None:
    got, want = float(port), float(np.asarray(ref))
    assert port.dtype == torch.float32
    cm = confmat.astype(np.float64)
    s, tk, pk = cm.sum(), cm.sum(1), cm.sum(0)
    denom = (s * s - (pk * pk).sum()) * (s * s - (tk * tk).sum())
    atol = 2 * s * s * U / math.sqrt(denom) if denom > 0 else 0.0
    assert abs(got - want) <= atol, (got, want, atol)


def assert_kappa(port, ref, num_classes: int) -> None:
    got, want = float(port), float(np.asarray(ref))
    assert port.dtype == torch.float32
    if math.isnan(want):
        assert math.isnan(got)
        return
    atol = 4 * math.ceil(math.log2(num_classes * num_classes)) * U * abs(1 - want)
    assert got == want or abs(got - want) <= atol, (got, want, atol)


def _confmats(seed: int = 0):
    """Random (C, C) int32 matrices: near chance, diagonal-heavy, and a zero row and column."""
    rng = np.random.default_rng(seed)
    out = []
    for c in (2, 13, 40):
        for hi in (3, 3000):
            cm = rng.integers(0, hi, (c, c)).astype(np.int32)
            out.append(cm)
            out.append(cm + np.diag(np.full(c, 2 * hi, np.int32)))
            absent = cm.copy()
            absent[1], absent[:, 1] = 0, 0
            out.append(absent)
    return out


# ------------------------------------------------------------------ Jaccard
@pytest.mark.parametrize("ignore_index", [None, 1, 7])
@pytest.mark.parametrize("average", AVERAGES, ids=str)
@pytest.mark.parametrize("case", CASES)
def test_jaccard_index_matches_jax(case, average, ignore_index):
    preds, target, num_classes = _case_inputs(case, seed=31)
    num_classes = max(num_classes, 2)  # a binary case counts two classes
    absent_score = 0.0
    if case == "multiclass_labels":  # class 2 absent from preds and target: its union is 0
        preds, target = np.where(preds == 2, 0, preds), np.where(target == 2, 0, target)
        absent_score = 0.5
    kwargs = dict(num_classes=num_classes, average=average, ignore_index=ignore_index, absent_score=absent_score)
    ref = jf.jaccard_index(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = tf.jaccard_index(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    assert_same(got, ref)


@pytest.mark.parametrize("average", AVERAGES, ids=str)
def test_jaccard_from_a_zero_confusion_matrix_matches_jax(average):
    """Every union 0: the absent score per class, and 0/0 = NaN for micro."""
    zero = np.zeros((4, 4), np.int32)
    assert_same(_jaccard_from_confmat(torch.from_numpy(zero), 4, average, None, 0.25),
                jax_jaccard(jnp.asarray(zero), 4, average, None, 0.25))


def test_jaccard_rejects_an_unknown_average_like_jax():
    cm = np.eye(3, dtype=np.int32)
    with pytest.raises(ValueError):
        jax_jaccard(jnp.asarray(cm), 3, "samples")
    with pytest.raises(ValueError):
        _jaccard_from_confmat(torch.from_numpy(cm), 3, "samples")


def test_multilabel_jaccard_raises_in_both():
    """A multilabel confusion matrix is (C, 2, 2): ``jnp.diag`` has no diagonal for it, so neither package returns a number."""
    preds, target, num_classes = _case_inputs("multilabel", seed=32)
    with pytest.raises(ValueError):
        jf.jaccard_index(jnp.asarray(preds), jnp.asarray(target), num_classes=num_classes, multilabel=True)
    with pytest.raises(ValueError, match=r"\(C, C\)"):
        tf.jaccard_index(torch.from_numpy(preds), torch.from_numpy(target), num_classes=num_classes, multilabel=True)
    ref = jm.JaccardIndex(num_classes=num_classes, multilabel=True, **EAGER)
    port = mt.JaccardIndex(num_classes=num_classes, multilabel=True, device="cpu")
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    port.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert_same(port.confmat, ref.confmat)  # the (C, 2, 2) counts themselves agree
    with pytest.raises(ValueError):
        ref.compute()
    with pytest.raises(ValueError):
        port.compute()


# ---------------------------------------------------------------- MCC, kappa
@pytest.mark.parametrize("case", CASES)
def test_matthews_corrcoef_matches_jax(case):
    preds, target, num_classes = _case_inputs(case, seed=33)
    num_classes = max(num_classes, 2)  # a binary case counts two classes
    ref = jf.matthews_corrcoef(jnp.asarray(preds), jnp.asarray(target), num_classes=num_classes)
    got = tf.matthews_corrcoef(torch.from_numpy(preds), torch.from_numpy(target), num_classes=num_classes)
    confmat = np.asarray(jf.confusion_matrix(jnp.asarray(preds), jnp.asarray(target), num_classes=num_classes))
    assert_mcc(got, ref, confmat)


@pytest.mark.parametrize("weights", WEIGHTS, ids=str)
@pytest.mark.parametrize("case", CASES)
def test_cohen_kappa_matches_jax(case, weights):
    preds, target, num_classes = _case_inputs(case, seed=34)
    num_classes = max(num_classes, 2)  # a binary case counts two classes
    ref = jf.cohen_kappa(jnp.asarray(preds), jnp.asarray(target), num_classes=num_classes, weights=weights)
    got = tf.cohen_kappa(torch.from_numpy(preds), torch.from_numpy(target), num_classes=num_classes, weights=weights)
    assert_kappa(got, ref, num_classes)


def test_mcc_and_kappa_from_random_confusion_matrices_match_jax():
    """Near chance the scores are small and the float32 cancellation shows: hence the tolerances above."""
    for cm in _confmats():
        assert_mcc(_matthews_corrcoef_compute(torch.from_numpy(cm)), jax_mcc(jnp.asarray(cm)), cm)
        for weights in WEIGHTS:
            assert_kappa(_cohen_kappa_compute(torch.from_numpy(cm), weights), jax_kappa(jnp.asarray(cm), weights), cm.shape[0])


def test_small_dyadic_confusion_matrices_give_bitwise_equal_scores():
    """Where every sum stays below 2**24 and no cancellation is rounded, the scores agree bit for bit."""
    for cm in (np.array([[2, 0], [1, 1]], np.int32), np.array([[5, 1, 2], [0, 4, 0], [3, 0, 1]], np.int32)):
        assert_same(_matthews_corrcoef_compute(torch.from_numpy(cm)), jax_mcc(jnp.asarray(cm)))
        assert _cohen_kappa_compute(torch.from_numpy(cm)).numpy().tobytes() == np.asarray(jax_kappa(jnp.asarray(cm))).tobytes()


def test_zero_denominators_match_jax():
    """All samples in one cell: MCC's denominator is 0 (it returns 0); kappa's expected
    disagreement is 0 (0/0, NaN in both)."""
    cm = np.zeros((3, 3), np.int32)
    cm[1, 1] = 7
    assert float(_matthews_corrcoef_compute(torch.from_numpy(cm))) == float(jax_mcc(jnp.asarray(cm))) == 0.0
    for weights in WEIGHTS:
        got, ref = _cohen_kappa_compute(torch.from_numpy(cm), weights), jax_kappa(jnp.asarray(cm), weights)
        assert np.isnan(float(ref)) and np.isnan(float(got))
    zero = np.zeros((3, 3), np.int32)
    assert float(_matthews_corrcoef_compute(torch.from_numpy(zero))) == float(jax_mcc(jnp.asarray(zero))) == 0.0


def test_unknown_kappa_weights_raise_in_both():
    with pytest.raises(ValueError):
        jm.CohenKappa(num_classes=3, weights="cubic", **EAGER)
    with pytest.raises(ValueError):
        mt.CohenKappa(num_classes=3, weights="cubic", device="cpu")
    cm = np.eye(3, dtype=np.int32)
    with pytest.raises(ValueError):
        jax_kappa(jnp.asarray(cm), "cubic")
    with pytest.raises(ValueError):
        _cohen_kappa_compute(torch.from_numpy(cm), "cubic")


# ------------------------------------------------------------------ modules
def _batches(seed: int = 40):
    rng = np.random.default_rng(seed)
    out = []
    for n in (50, 30, 20):
        logits = rng.standard_normal((n, 5)).astype(np.float32)
        out.append((np.exp(logits) / np.exp(logits).sum(1, keepdims=True), rng.integers(0, 5, n)))
    return out


MODULES = {
    "jaccard_macro": lambda pkg, **kw: pkg.JaccardIndex(num_classes=5, **kw),
    "jaccard_weighted_ignore": lambda pkg, **kw: pkg.JaccardIndex(num_classes=5, average="weighted", ignore_index=2, **kw),
    "jaccard_none": lambda pkg, **kw: pkg.JaccardIndex(num_classes=5, average="none", absent_score=1.0, **kw),
    "mcc": lambda pkg, **kw: pkg.MatthewsCorrCoef(num_classes=5, **kw),
    "kappa": lambda pkg, **kw: pkg.CohenKappa(num_classes=5, **kw),
    "kappa_quadratic": lambda pkg, **kw: pkg.CohenKappa(num_classes=5, weights="quadratic", **kw),
}


def _assert_score(name: str, port, ref, confmat: np.ndarray) -> None:
    if name.startswith("mcc"):
        assert_mcc(port, ref, confmat)
    elif name.startswith("kappa"):
        assert_kappa(port, ref, confmat.shape[0])
    else:
        assert_same(port, ref)


@pytest.mark.parametrize("name", MODULES)
def test_modules_stream_like_jax(name):
    ref, port = MODULES[name](jm, **EAGER), MODULES[name](mt, device="cpu")
    for preds, target in _batches():
        batch_ref = ref(jnp.asarray(preds), jnp.asarray(target))
        batch_port = port(torch.from_numpy(preds), torch.from_numpy(target))
        batch_cm = np.asarray(jf.confusion_matrix(jnp.asarray(preds), jnp.asarray(target), num_classes=5))
        _assert_score(name, batch_port, batch_ref, batch_cm)
        assert_same(port.confmat, ref.confmat)
    _assert_score(name, port.compute(), ref.compute(), np.asarray(ref.confmat))
    port.reset()
    assert port.confmat.dtype == torch.int32 and not port.confmat.any()


def _family(pkg, **kwargs):
    return pkg.MetricCollection(
        {
            "cm": pkg.ConfusionMatrix(num_classes=5, **kwargs),
            "jaccard": pkg.JaccardIndex(num_classes=5, **kwargs),
            "mcc": pkg.MatthewsCorrCoef(num_classes=5, **kwargs),
            "kappa": pkg.CohenKappa(num_classes=5, **kwargs),
            "acc": pkg.Accuracy(num_classes=5, **kwargs),
        },
        **({"device": "cpu"} if "device" in kwargs else {}),
    )


def test_collection_compute_groups_equal_the_jax_collection():
    ref, port = _family(jm, **EAGER), _family(mt, device="cpu")
    for preds, target in _batches(seed=41):
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
    groups = [sorted(g) for g in port.compute_groups.values()]
    assert groups == [sorted(g) for g in ref.compute_groups.values()]
    assert sorted(groups) == [["acc"], ["cm", "jaccard", "kappa", "mcc"]]
    for name in ("jaccard", "mcc", "kappa"):  # one bincount per batch: the members hold the leader's tensor
        assert port[name].confmat is port["cm"].confmat
    got, want = port.compute(), ref.compute()
    confmat = np.asarray(ref["cm"].confmat)
    assert_same(got["cm"], want["cm"])
    assert_same(got["jaccard"], want["jaccard"])
    assert_mcc(got["mcc"], want["mcc"], confmat)
    assert_kappa(got["kappa"], want["kappa"], 5)


@pytest.mark.parametrize("name", ["jaccard_weighted_ignore", "mcc", "kappa_quadratic"])
def test_load_jax_state_carries_a_mid_stream_metric_across(name):
    batches = _batches(seed=42)
    ref = MODULES[name](jm, **EAGER)
    for preds, target in batches[:2]:
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    port = MODULES[name](mt, device="cpu")
    mt.load_jax_state(port, ref.state_pytree())
    assert port.update_count == 2 and port.confmat.dtype == torch.int32
    preds, target = batches[2]
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    port.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert_same(port.confmat, ref.confmat)
    _assert_score(name, port.compute(), ref.compute(), np.asarray(ref.confmat))
