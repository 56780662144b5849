"""Float64 inputs at the port's input boundary, against the JAX package.

With ``jax_enable_x64`` off the JAX package rounds float64 inputs to float32
(``jnp.asarray``) before it ranks or thresholds them.  The port must take the
same decisions: two float64 logits that round to one float32 value tie (and
the tie goes to the lower index, as ``lax.top_k`` breaks it), and a float64
probability within float32 rounding of ``threshold`` lands on the threshold.
Counts must match bitwise.
"""

import numpy as np
import torch

import metrics_tpu as jm
import metrics_tpu.functional as jf
import metrics_tpu_torch as mt

# rows whose two largest logits differ in float64 but are one float32 value
LOGITS = np.array(
    [
        [1.0, 1.0 + 1e-12, 0.5],
        [0.25, -3.0, 0.25 + 1e-13],
        [2.0 - 1e-13, 2.0, -1.0],
    ],
    np.float64,
)
LABELS = np.array([1, 2, 1])
# probabilities that sit within float32 rounding of the threshold 0.5
PROBS = np.array([0.5 - 1e-12, 0.5 + 1e-12, 0.5 - 1e-10, 0.9, 0.1], np.float64)
TARGETS = np.array([1, 0, 1, 1, 0])
# the JAX reference runs eagerly (the same values, without a jit compile per instance)
EAGER = {"jit_update": False, "jit_compute": False}


def test_float64_logits_round_to_float32_before_the_argmax():
    assert (LOGITS.astype(np.float32).argmax(1) != LOGITS.argmax(1)).all()
    ref = jm.StatScores(reduce="macro", num_classes=3, **EAGER)
    ref.update(LOGITS, LABELS)
    port = mt.StatScores(reduce="macro", num_classes=3, device="cpu")
    port.update(torch.from_numpy(LOGITS), torch.from_numpy(LABELS))
    np.testing.assert_array_equal(port.compute().numpy(), np.asarray(ref.compute()))
    got = mt.accuracy(torch.from_numpy(LOGITS), torch.from_numpy(LABELS))
    assert float(got) == float(jf.accuracy(LOGITS, LABELS))


def test_float64_probabilities_round_to_float32_before_the_threshold():
    threshold = 0.5
    as32 = PROBS.astype(np.float32) >= threshold
    assert (as32 != (PROBS >= threshold))[:3].any()
    ref = jm.StatScores(threshold=threshold, **EAGER)
    ref.update(PROBS, TARGETS)
    port = mt.StatScores(threshold=threshold, device="cpu")
    port.update(torch.from_numpy(PROBS), torch.from_numpy(TARGETS))
    np.testing.assert_array_equal(port.compute().numpy(), np.asarray(ref.compute()))
    got = mt.stat_scores(torch.from_numpy(PROBS), torch.from_numpy(TARGETS), threshold=threshold)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jf.stat_scores(PROBS, TARGETS, threshold=threshold)))
