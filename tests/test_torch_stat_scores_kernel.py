"""The stat-scores kernel's plain version and wrapper against the JAX package.

On the CPU the port's :func:`fused_stat_scores` takes its plain version; it is
held bitwise against the Pallas kernel in interpret mode (as
``tests/test_pallas_ops.py`` runs it) and, above the Pallas kernel's class
cap, against the JAX package's jnp reductions.  The engine's choice between
the logits route (:func:`fused_stat_scores_logits`) and the canonical route
is checked here too, with its results against the JAX package's.  The CUDA
kernels themselves are compared with their plain versions on the card by
``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.functional.classification.stat_scores import _stat_scores as jax_stat_scores
from metrics_tpu.ops import fused_stat_scores as pallas_stat_scores
from metrics_tpu_torch.functional.classification.stat_scores import _stat_scores
from metrics_tpu_torch.ops import stat_scores as ops


def _operands(n, c, dtype, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, (n, c)).astype(dtype), rng.integers(0, 2, (n, c)).astype(dtype)


def _assert_counts_equal(got, expected):
    assert len(got) == len(expected) == 4
    for g, e in zip(got, expected):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


@pytest.mark.parametrize("dtype", [np.int32, np.bool_])
@pytest.mark.parametrize("n,c", [(512, 8), (1000, 5), (3, 7), (0, 4)])
def test_plain_matches_pallas_interpret(n, c, dtype):
    p, t = _operands(n, c, dtype, seed=n + c)
    expected = pallas_stat_scores(jnp.asarray(p, jnp.int32), jnp.asarray(t, jnp.int32), interpret=True)
    _assert_counts_equal(ops.fused_stat_scores_plain(torch.from_numpy(p), torch.from_numpy(t)), expected)


def test_plain_matches_jnp_above_pallas_class_cap():
    p, t = _operands(70, 1030, np.int32, seed=1)
    expected = jax_stat_scores(jnp.asarray(p), jnp.asarray(t), reduce="macro")
    _assert_counts_equal(ops.fused_stat_scores_plain(torch.from_numpy(p), torch.from_numpy(t)), expected)


@pytest.mark.parametrize("reduce", ["micro", "macro", "samples"])
@pytest.mark.parametrize("shape", [(40, 6), (10, 4, 3)])
def test_stat_scores_engine_matches_jnp(reduce, shape):
    rng = np.random.default_rng(2)
    p = rng.integers(0, 2, shape).astype(np.int32)
    t = rng.integers(0, 2, shape).astype(np.int32)
    expected = jax_stat_scores(jnp.asarray(p), jnp.asarray(t), reduce=reduce)
    _assert_counts_equal(_stat_scores(torch.from_numpy(p), torch.from_numpy(t), reduce=reduce), expected)


def test_wrapper_takes_plain_path_on_cpu_and_counts_no_launch():
    p, t = _operands(37, 9, np.int32, seed=3)
    before = ops.fused_stat_scores.launches
    got = ops.fused_stat_scores(torch.from_numpy(p), torch.from_numpy(t))
    _assert_counts_equal(got, ops.fused_stat_scores_plain(torch.from_numpy(p), torch.from_numpy(t)))
    assert ops.fused_stat_scores.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    p = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.fused_stat_scores(p.long(), p.long())
    with pytest.raises(TypeError):
        ops.fused_stat_scores(p, p.bool())
    with pytest.raises(ValueError):
        ops.fused_stat_scores(p, p[:4])
    with pytest.raises(ValueError):
        ops.fused_stat_scores(p[:, :1].reshape(8), p[:, :1].reshape(8))
    with pytest.raises(ValueError):
        ops.fused_stat_scores(p.t(), p.t())
    with pytest.raises(ValueError):
        ops.fused_stat_scores(p, torch.zeros((8, 4), dtype=torch.int32, device="meta"))


def _logits_inputs(seed, n=40, c=6, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.integers(-16, 17, (n, c)) / 8).astype(dtype), rng.integers(0, c, n)


# (inputs, keyword arguments, route): which calls count straight from the logits
ROUTING_CASES = {
    "macro": (lambda: _logits_inputs(10), dict(reduce="macro", num_classes=6), "logits"),
    "micro": (lambda: _logits_inputs(11), dict(reduce="micro"), "logits"),
    "top_k_1": (lambda: _logits_inputs(12), dict(reduce="macro", num_classes=6, top_k=1), "logits"),
    "multiclass_true": (lambda: _logits_inputs(13), dict(reduce="micro", multiclass=True), "logits"),
    "int32_labels": (
        lambda: (lambda x, y: (x, y.astype(np.int32)))(*_logits_inputs(14)), dict(reduce="macro", num_classes=6),
        "logits",
    ),
    "ignore_index": (lambda: _logits_inputs(15), dict(reduce="macro", num_classes=6, ignore_index=2), "canonical"),
    "top_k_2": (lambda: _logits_inputs(16), dict(reduce="micro", top_k=2), "canonical"),
    "multiclass_false": (lambda: _logits_inputs(17, c=2), dict(reduce="macro", num_classes=2, multiclass=False),
                         "canonical"),
    "samples": (lambda: _logits_inputs(18), dict(reduce="samples"), "canonical"),
    "integer_preds": (
        lambda: (lambda x, y: (np.argmax(x, 1), y))(*_logits_inputs(19)), dict(reduce="macro", num_classes=6),
        "canonical",
    ),
    # float64 rounds to float32 at the input boundary, as jnp.asarray rounds it
    "float64_logits": (lambda: _logits_inputs(20, dtype=np.float64), dict(reduce="macro", num_classes=6),
                       "logits"),
    "multidim": (
        lambda: (np.random.default_rng(21).random((12, 6, 3)).astype(np.float32),
                 np.random.default_rng(22).integers(0, 6, (12, 3))),
        dict(reduce="macro", num_classes=6, mdmc_reduce="global"),
        "canonical",
    ),
}


@pytest.mark.parametrize("case", list(ROUTING_CASES))
def test_engine_routes_logits_and_keeps_the_canonical_route(case, monkeypatch):
    from metrics_tpu.functional.classification.stat_scores import _stat_scores_update as jax_update
    from metrics_tpu_torch.functional.classification.stat_scores import _stat_scores_update

    make, kwargs, route = ROUTING_CASES[case]
    preds, target = make()
    engine = sys.modules["metrics_tpu_torch.functional.classification.stat_scores"]
    calls = []
    monkeypatch.setattr(
        engine, "fused_stat_scores_logits", lambda *args: calls.append(args) or ops.fused_stat_scores_logits(*args)
    )
    got = _stat_scores_update(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    assert len(calls) == (route == "logits")
    _assert_counts_equal(got, jax_update(jnp.asarray(preds), jnp.asarray(target), **kwargs))


def test_logits_wrapper_takes_plain_path_on_cpu_and_counts_no_launch():
    x, y = _logits_inputs(30, n=37, c=9)
    logits, labels = torch.from_numpy(x), torch.from_numpy(y)
    before = ops.fused_stat_scores_logits.launches
    _assert_counts_equal(ops.fused_stat_scores_logits(logits, labels), ops.fused_stat_scores_logits_plain(logits, labels))
    assert ops.fused_stat_scores_logits.launches == before


def test_logits_wrapper_rejects_what_the_kernel_does_not_take():
    logits, labels = torch.zeros((8, 4)), torch.zeros(8, dtype=torch.int64)
    with pytest.raises(TypeError):
        ops.fused_stat_scores_logits(logits.double(), labels)
    with pytest.raises(TypeError):
        ops.fused_stat_scores_logits(logits, labels.to(torch.int16))
    with pytest.raises(ValueError):
        ops.fused_stat_scores_logits(logits, labels[:4])
    with pytest.raises(ValueError):
        ops.fused_stat_scores_logits(logits[:, :0], labels)
    with pytest.raises(ValueError):
        ops.fused_stat_scores_logits(logits.t(), labels[:4])
    with pytest.raises(ValueError):
        ops.fused_stat_scores_logits(logits.t().contiguous().t(), labels)
    with pytest.raises(ValueError):
        ops.fused_stat_scores_logits(logits, torch.zeros(8, dtype=torch.int64, device="meta"))
