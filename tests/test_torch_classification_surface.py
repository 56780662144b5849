"""The port exports every name of the JAX package's classification layer, and
``precision_recall`` (the functional the port lacked) against the JAX package's.

Floats compare to ``rtol=1e-6, atol=1e-7`` (``tests/test_torch_classification.py``).
"""

import pytest
import torch

import metrics_tpu.classification as jc
import metrics_tpu.functional as jf
import metrics_tpu.functional.classification as jfc
import metrics_tpu_torch as mt
import metrics_tpu_torch.classification as tc
import metrics_tpu_torch.functional as tf
import metrics_tpu_torch.functional.classification as tfc
from tests.test_torch_classification import AVERAGES, CASES, _case_inputs, _compare


def test_every_classification_module_of_the_jax_package_is_exported():
    assert set(jc.__all__) <= set(tc.__all__) <= set(mt.__all__)
    for name in jc.__all__:
        assert getattr(mt, name) is getattr(tc, name)


def test_every_classification_functional_of_the_jax_package_is_exported():
    assert set(jfc.__all__) <= set(tfc.__all__) <= set(tf.__all__) <= set(mt.__all__)
    for name in jfc.__all__:
        assert getattr(mt, name) is getattr(tf, name) is getattr(tfc, name)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("average", AVERAGES)
def test_precision_recall_matches_jax(case, average):
    preds, target, num_classes = _case_inputs(case, seed=51)
    kwargs = dict(average=average, num_classes=num_classes)
    if case == "mdmc_probs":
        kwargs["mdmc_average"] = "global"
    _compare(jf.precision_recall, tf.precision_recall, preds, target, **kwargs)


def test_precision_recall_equals_precision_and_recall():
    preds, target, num_classes = _case_inputs("multiclass_probs", seed=52)
    p, r = tf.precision_recall(torch.from_numpy(preds), torch.from_numpy(target), average="macro", num_classes=num_classes)
    assert torch.equal(p, tf.precision(torch.from_numpy(preds), torch.from_numpy(target), average="macro", num_classes=num_classes))
    assert torch.equal(r, tf.recall(torch.from_numpy(preds), torch.from_numpy(target), average="macro", num_classes=num_classes))
