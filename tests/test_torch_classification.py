"""The port's classification functionals against the JAX package, on the CPU.

The same numpy inputs (made from a seed) go through ``metrics_tpu`` and
``metrics_tpu_torch``.  Integer outputs must match bitwise.  Float outputs
match to ``rtol=1e-6, atol=1e-7``: both sides compute in float32, but torch
and XLA may sum the per-class scores in another order.  Where the JAX
function rejects an input, the port must raise the same exception type.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.functional as jf
import metrics_tpu_torch.functional as tf

N, C, X = 64, 6, 3


def _tie_free_scores(rng, shape_nc_rest):
    """Scores in (0, 1) with distinct values along axis 1, so top-k picks the same classes in both packages."""
    n, c = shape_nc_rest[:2]
    rest = shape_nc_rest[2:]
    ranks = np.argsort(rng.random((n, c) + rest), axis=1)
    return ((ranks + 0.5) / c).astype(np.float32)


def _case_inputs(case: str, seed: int = 7):
    rng = np.random.default_rng(seed)
    if case == "binary_probs":
        return rng.random(N).astype(np.float32), rng.integers(0, 2, N).astype(np.int32), 1
    if case == "multiclass_labels":
        return rng.integers(0, C, N).astype(np.int32), rng.integers(0, C, N).astype(np.int32), C
    if case == "multiclass_probs":
        return _tie_free_scores(rng, (N, C)), rng.integers(0, C, N).astype(np.int32), C
    if case == "multilabel":
        return rng.random((N, C)).astype(np.float32), rng.integers(0, 2, (N, C)).astype(np.int32), C
    if case == "mdmc_probs":
        return _tie_free_scores(rng, (N, C, X)), rng.integers(0, C, (N, X)).astype(np.int32), C
    raise ValueError(case)


CASES = ["binary_probs", "multiclass_labels", "multiclass_probs", "multilabel", "mdmc_probs"]
AVERAGES = ["micro", "macro", "weighted", "none"]


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


def _compare(jax_fn, torch_fn, preds, target, **kwargs) -> None:
    try:
        expected = jax_fn(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    except (ValueError, RuntimeError) as err:
        with pytest.raises(type(err)):
            torch_fn(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
        return
    got = torch_fn(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    if isinstance(expected, tuple):
        for g, e in zip(got, expected):
            assert_same(g, e)
    else:
        assert_same(got, expected)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("name", ["accuracy", "precision", "recall", "f1_score"])
def test_averaged_functionals_match_jax(name, average, case):
    preds, target, num_classes = _case_inputs(case)
    kwargs = dict(average=average, num_classes=num_classes)
    if case == "mdmc_probs":
        kwargs["mdmc_average"] = "global"
    _compare(getattr(jf, name), getattr(tf, name), preds, target, **kwargs)


@pytest.mark.parametrize("name", ["accuracy", "precision", "recall", "f1_score"])
@pytest.mark.parametrize("average", ["micro", "macro", "none"])
def test_top_k_matches_jax(name, average):
    preds, target, num_classes = _case_inputs("multiclass_probs", seed=11)
    _compare(getattr(jf, name), getattr(tf, name), preds, target,
             average=average, num_classes=num_classes, top_k=2)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("reduce", ["micro", "macro", "samples"])
def test_stat_scores_matches_jax(case, reduce):
    preds, target, num_classes = _case_inputs(case, seed=3)
    kwargs = dict(reduce=reduce, num_classes=num_classes)
    if case == "mdmc_probs":
        kwargs["mdmc_reduce"] = "global"
    _compare(jf.stat_scores, tf.stat_scores, preds, target, **kwargs)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("normalize", [None, "true"])
def test_confusion_matrix_matches_jax(case, normalize):
    preds, target, num_classes = _case_inputs(case, seed=5)
    kwargs = dict(num_classes=max(num_classes, 2), normalize=normalize)
    if case == "multilabel":
        kwargs["multilabel"] = True
    if case == "mdmc_probs":
        preds, target = preds[:, :, 0], target[:, 0]
    _compare(jf.confusion_matrix, tf.confusion_matrix, preds, target, **kwargs)


def test_ignore_index_matches_jax():
    preds, target, num_classes = _case_inputs("multiclass_labels", seed=13)
    for average in AVERAGES:
        _compare(jf.accuracy, tf.accuracy, preds, target, average=average, num_classes=num_classes, ignore_index=2)
        _compare(jf.f1_score, tf.f1_score, preds, target, average=average, num_classes=num_classes, ignore_index=2)


def test_invalid_labels_raise_in_both():
    preds, target, num_classes = _case_inputs("multiclass_labels", seed=17)
    target = target.copy()
    target[0] = num_classes  # out of range
    _compare(jf.accuracy, tf.accuracy, preds, target, average="macro", num_classes=num_classes)
