"""The port's Specificity, Dice and HammingDistance against the JAX package, on the CPU.

The functionals run over the ``CASES`` x ``AVERAGES`` grid of
``tests/test_torch_classification.py``; the modules stream the same inputs
in three batches.  Integer counts match bitwise; the float scores to
``rtol=1e-6, atol=1e-7`` (float32 on both sides, summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.functional as jf
import metrics_tpu_torch as mt
import metrics_tpu_torch.functional as tf
from tests.test_torch_classification import AVERAGES, CASES, _case_inputs, _compare, assert_same

EAGER = {"jit_update": False, "jit_compute": False}


def _kwargs(case: str, average: str, num_classes: int) -> dict:
    kwargs = dict(average=average, num_classes=num_classes)
    if case == "mdmc_probs":
        kwargs["mdmc_average"] = "global"
    return kwargs


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("name", ["specificity", "dice"])
def test_functionals_match_jax(name, average, case):
    preds, target, num_classes = _case_inputs(case, seed=21)
    _compare(getattr(jf, name), getattr(tf, name), preds, target, **_kwargs(case, average, num_classes))


@pytest.mark.parametrize("zero_division", [0, 1])
def test_dice_zero_division_matches_jax(zero_division):
    preds, target, num_classes = _case_inputs("multiclass_labels", seed=22)
    target = np.where(target == 3, 0, target)
    preds = np.where(preds == 3, 0, preds)  # class 3 absent from both: 0/0
    for average in AVERAGES:
        _compare(jf.dice, tf.dice, preds, target, average=average, num_classes=num_classes,
                 zero_division=zero_division)


@pytest.mark.parametrize("bg", [False, True])
def test_dice_score_matches_jax(bg):
    preds, target, _ = _case_inputs("multiclass_probs", seed=23)
    with pytest.warns(DeprecationWarning):
        _compare(jf.dice_score, tf.dice_score, preds, target, bg=bg)


@pytest.mark.parametrize("threshold", [0.5, 0.3])
@pytest.mark.parametrize("case", CASES)
def test_hamming_distance_matches_jax(case, threshold):
    preds, target, _ = _case_inputs(case, seed=24)
    _compare(jf.hamming_distance, tf.hamming_distance, preds, target, threshold=threshold)


def _streamed(ref, port, preds, target):
    cuts = np.linspace(0, len(target), 4).astype(int)
    for a, b in zip(cuts, cuts[1:]):
        ref.update(jnp.asarray(preds[a:b]), jnp.asarray(target[a:b]))
        port.update(torch.from_numpy(preds[a:b]), torch.from_numpy(target[a:b]))
    return port, ref


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("name", ["Specificity", "Dice"])
def test_modules_streamed_match_jax(name, average, case):
    preds, target, num_classes = _case_inputs(case, seed=25)
    kwargs = _kwargs(case, average, num_classes)
    if "mdmc_average" in kwargs:
        kwargs["mdmc_average"] = "global"
    port, ref = _streamed(getattr(jm, name)(**kwargs, **EAGER), getattr(mt, name)(**kwargs, device="cpu"), preds, target)
    for state in ("tp", "fp", "tn", "fn"):
        assert_same(getattr(port, state), ref._state[state])
    assert_same(port.compute(), ref.compute())


@pytest.mark.parametrize("case", CASES)
def test_hamming_module_streamed_matches_jax(case):
    preds, target, _ = _case_inputs(case, seed=26)
    port, ref = _streamed(jm.HammingDistance(**EAGER), mt.HammingDistance(device="cpu"), preds, target)
    for state in ("correct", "total"):
        assert_same(getattr(port, state), ref._state[state])
    assert_same(port.compute(), ref.compute())


def test_specificity_and_dice_share_one_stat_scores_group():
    preds, target, num_classes = _case_inputs("multiclass_probs", seed=27)
    col = mt.MetricCollection(
        {"spec": mt.Specificity(num_classes=num_classes, average="macro", device="cpu"),
         "dice": mt.Dice(num_classes=num_classes, average="macro", device="cpu"),
         "hamming": mt.HammingDistance(device="cpu")},
        device="cpu",
    )
    for _ in range(2):
        col.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert sorted(map(sorted, col.compute_groups.values())) == [["dice", "spec"], ["hamming"]]
    out = col.compute()
    assert_same(out["spec"], jf.specificity(jnp.asarray(np.concatenate([preds] * 2)), jnp.asarray(np.concatenate([target] * 2)),
                                             average="macro", num_classes=num_classes))
