"""The ported slice as a whole against the JAX package, on the CPU.

Configuration 2 (``Accuracy``/``F1Score``/``ConfusionMatrix`` in a
``MetricCollection`` with compute groups) and configuration 1 (``Accuracy``
driven by ``forward``) stream the same seeded batches through both packages.
Integer results match bitwise, float results to ``rtol=1e-6, atol=1e-7``
(float32 on both sides; torch and XLA may sum per-class scores in another
order).  A JAX metric's state carried across mid-stream with
``load_jax_state`` must finish at the JAX metric's own result.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu_torch as mt

C = 7
SIZES = (48, 48, 48, 21)


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for size in SIZES:
        scores = ((np.argsort(rng.random((size, C)), axis=1) + 0.5) / C).astype(np.float32)
        out.append((scores, rng.integers(0, C, size).astype(np.int32)))
    return out


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


def _config2(pkg, **kwargs):
    return pkg.MetricCollection(
        {
            "acc": pkg.Accuracy(num_classes=C, average="macro", **kwargs),
            "f1": pkg.F1Score(num_classes=C, average="macro", **kwargs),
            "prec": pkg.Precision(num_classes=C, average="macro", **kwargs),
            "cm": pkg.ConfusionMatrix(num_classes=C, **kwargs),
        },
        **kwargs,
    )


def test_collection_with_compute_groups_matches_jax():
    ref = _config2(jm)
    port = _config2(mt, device="cpu")
    for preds, target in _batches():
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert port.compute_groups == ref.compute_groups
    assert port.compute_groups == {0: ["acc"], 1: ["cm"], 2: ["f1", "prec"]}
    expected, got = ref.compute(), port.compute()
    assert sorted(got) == sorted(expected)
    for key in expected:
        assert_same(got[key], expected[key])
    # members of a group point at their leader's state
    assert port["prec"].tp is port["f1"].tp


def test_collection_forward_matches_jax():
    ref = _config2(jm)
    port = _config2(mt, device="cpu")
    for preds, target in _batches(seed=1):
        expected = ref(jnp.asarray(preds), jnp.asarray(target))
        got = port(torch.from_numpy(preds), torch.from_numpy(target))
        for key in expected:
            assert_same(got[key], expected[key])
    for key, value in ref.compute().items():
        assert_same(port.compute()[key], value)


@pytest.mark.parametrize("input_kind", ["probs", "labels"])
def test_config1_accuracy_forward_matches_jax(input_kind):
    ref = jm.Accuracy(num_classes=C)
    port = mt.Accuracy(num_classes=C, device="cpu")
    for preds, target in _batches(seed=2):
        if input_kind == "labels":
            preds = preds.argmax(1).astype(np.int32)
        assert_same(port(torch.from_numpy(preds), torch.from_numpy(target)),
                    ref(jnp.asarray(preds), jnp.asarray(target)))
    assert_same(port.compute(), ref.compute())


@pytest.mark.parametrize("via", ["state_pytree", "state_dict"])
@pytest.mark.parametrize(
    "make",
    [
        lambda pkg, **kw: pkg.Accuracy(num_classes=C, average="macro", **kw),
        lambda pkg, **kw: pkg.F1Score(num_classes=C, average="macro", **kw),
        lambda pkg, **kw: pkg.StatScores(reduce="samples", num_classes=C, **kw),
        lambda pkg, **kw: pkg.ConfusionMatrix(num_classes=C, **kw),
    ],
    ids=["accuracy_macro", "f1_macro", "stat_scores_samples", "confusion_matrix"],
)
def test_state_carried_across_from_jax_finishes_equal(make, via):
    batches = _batches(seed=3)
    half = len(batches) // 2
    ref = make(jm)
    for preds, target in batches[:half]:
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    if via == "state_pytree":
        state = {k: v if k == "_update_count" else np.asarray(v) for k, v in ref.state_pytree().items()}
    else:
        ref.persistent(True)
        state = ref.state_dict()
    port = make(mt, device="cpu")
    mt.load_jax_state(port, state, extra=ref._ckpt_extra_state())
    if via == "state_pytree":
        assert port.update_count == half
    for name, default in port._defaults.items():
        value = getattr(port, name)
        for v in value if isinstance(value, list) else [value]:
            assert v.dtype == torch.int32 and v.device == port.device
    for preds, target in batches[half:]:
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert_same(port.compute(), ref.compute())


def test_load_jax_state_rejects_a_mismatched_state():
    ref = jm.F1Score(num_classes=C, average="macro")
    ref.update(*(jnp.asarray(x) for x in _batches(seed=4)[0]))
    state = {k: v if k == "_update_count" else np.asarray(v) for k, v in ref.state_pytree().items()}
    port = mt.F1Score(num_classes=C, average="macro", device="cpu")
    with pytest.raises(ValueError, match="int64"):
        mt.load_jax_state(port, {**state, "tp": state["tp"].astype(np.int64)})
    with pytest.raises(KeyError):
        mt.load_jax_state(port, {**state, "confmat": state["tp"]})
