"""Dtype casts and gradients of the port against the JAX package.

* ``set_dtype``, ``half`` and ``double``: the dtype of every state equals the
  JAX package's exactly after the same calls.  ``half()`` is bfloat16 (the
  JAX package's definition, not ``nn.Module.half``'s float16) on a
  ``Metric`` and a ``MetricCollection`` alike; ``double()`` gives float32
  states, as the JAX package gives without 64-bit types; integer states and
  buffer row counts keep their dtypes.  Values after a cast: bf16 values
  equal the JAX package's within one bf16 ulp (``2**-8`` relative; both
  packages round the same float32 accumulations, and a division in bf16
  may round once more); float32 values within ``F32_RTOL`` (``2**-21``,
  four float32 ulps: torch and XLA sum a batch in another order), the
  dummy's exact sums bitwise.
* Gradients: ``torch.autograd.grad`` of the port's differentiable
  regression functionals, and of ``apply_update`` + ``apply_compute`` of
  ``MeanSquaredError`` inside a loss, against ``jax.grad`` of the JAX
  package's (``tests/bases/test_dtype_and_grad.py:72-107``) on seeded
  inputs, to ``rtol=1e-5`` (float32 gradients; the two autodiffs may order
  their sums differently), and the JAX test's own check against central
  finite differences for the port's MSE.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import metrics_tpu as jm
import metrics_tpu.functional as jf
import metrics_tpu_torch as mt
import metrics_tpu_torch.functional as tf
from tests.bases.dummies import DummyMetricSum as JaxSum

EAGER = {"jit_update": False, "jit_compute": False}
BF16_RTOL = 2.0**-8
F32_RTOL = 2.0**-21
_rng = np.random.default_rng(0)


class DummyMetricSum(mt.Metric):
    full_state_update = True

    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("x", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, x):
        self.x = self.x + torch.as_tensor(x, dtype=torch.float32)

    def compute(self):
        return self.x


def _np(v):
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return v.detach().numpy()
    return np.asarray(v)


def _state_dtypes(metric):
    out = {}
    for name, value in metric.state.items():
        if isinstance(value, list):
            out[name] = [str(_np(v).dtype) for v in value]
        elif isinstance(value, int):
            out[name] = "int"
        else:
            out[name] = str(_np(value).dtype)
    return out


def _jax_state_dtypes(metric):
    return {
        name: ([str(np.asarray(v).dtype) for v in value] if isinstance(value, list)
               else "int" if isinstance(value, int) else str(np.asarray(value).dtype))
        for name, value in metric.state.items()
    }


def assert_close_bf16(port, ref):
    port, ref = _np(port), np.asarray(ref)
    assert port.dtype == ref.dtype, (port.dtype, ref.dtype)
    np.testing.assert_allclose(port.astype(np.float32), ref.astype(np.float32), rtol=BF16_RTOL, atol=0)


@pytest.mark.parametrize("cast", ["half", "float", "double", "set_dtype_bf16", "set_dtype_f64"])
def test_dummy_state_dtypes_and_values(cast):
    def run(m):
        for v in (1.5, 2.25, -0.125):
            m.update(v)
        if cast.startswith("set_dtype"):
            dst = {"bf16": (torch.bfloat16, jnp.bfloat16), "f64": (torch.float64, jnp.float64)}[cast.split("_")[-1]]
            m.set_dtype(dst[0] if isinstance(m, mt.Metric) else dst[1])
        else:
            getattr(m, cast)()
        return m

    port, ref = run(DummyMetricSum()), run(JaxSum())
    assert _state_dtypes(port) == _jax_state_dtypes(ref)
    np.testing.assert_array_equal(_np(port.compute()).astype(np.float32), np.asarray(ref.compute(), np.float32))


def test_half_is_bfloat16_and_float_restores():
    m = DummyMetricSum()
    m.update(1.5)
    assert m.half() is m and m.x.dtype == torch.bfloat16
    assert m.float().x.dtype == torch.float32
    assert m.double().x.dtype == torch.float32  # no 64-bit types, as in the JAX package
    m.half()
    m.reset()
    assert m.x.dtype == torch.float32  # a reset restores the defaults, as in the JAX package


def test_cast_clears_delta_cache_and_cached_value():
    m = mt.CatMetric(sync_backend=mt.parallel.LoopbackBackend(), device="cpu")
    m.update(torch.arange(4.0))
    m.compute()
    assert m._delta_cache.round == 1
    m.half()
    assert m._delta_cache.round == 0 and m._computed is None
    assert m.compute().dtype == torch.bfloat16


@pytest.mark.parametrize(
    "name, make, kwargs",
    [
        ("MeanSquaredError", lambda: (_rng.random(64, dtype=np.float32), _rng.random(64, dtype=np.float32)), {}),
        ("Accuracy", lambda: (_rng.random((32, 4), dtype=np.float32), _rng.integers(0, 4, 32)), {"num_classes": 4}),
        ("AUROC", lambda: (_rng.random((32, 3), dtype=np.float32), _rng.integers(0, 3, 32)), {"num_classes": 3}),
        ("PearsonCorrCoef", lambda: (_rng.random(64, dtype=np.float32), _rng.random(64, dtype=np.float32)), {}),
    ],
)
@pytest.mark.parametrize("when", ["after_updates", "before_updates"])
def test_real_metrics_against_jax(name, make, kwargs, when):
    batches = [make() for _ in range(2)]
    if name == "AUROC":
        batches = [(p / p.sum(1, keepdims=True), t) for p, t in batches]
    port = getattr(mt, name)(device="cpu", **kwargs)
    ref = getattr(jm, name)(**EAGER, **kwargs)
    if when == "before_updates":
        port.half()
        ref.half()
    for p, t in batches:
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
    if when == "after_updates":
        port.half()
        ref.half()
    assert _state_dtypes(port) == _jax_state_dtypes(ref)
    got, want = port.compute(), ref.compute()
    if _np(got).dtype == np.dtype(ml_dtypes.bfloat16):
        assert_close_bf16(got, want)
    else:
        assert _np(got).dtype == np.asarray(want).dtype
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=F32_RTOL, atol=0)


def test_mse_bf16_inputs_accumulate_in_float32_like_jax():
    preds = _rng.random(64, dtype=np.float32).astype(ml_dtypes.bfloat16)
    target = _rng.random(64, dtype=np.float32).astype(ml_dtypes.bfloat16)
    m = mt.MeanSquaredError(device="cpu").half()
    assert m.sum_squared_error.dtype == torch.bfloat16
    as_torch = lambda a: torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)  # noqa: E731
    m.update(as_torch(preds), as_torch(target))
    ref = jm.MeanSquaredError(**EAGER)
    ref.half()
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    # the update accumulates in float32 by design, in both packages
    assert m.sum_squared_error.dtype == torch.float32 and ref.sum_squared_error.dtype == jnp.float32
    np.testing.assert_allclose(_np(m.compute()), np.asarray(ref.compute()), rtol=F32_RTOL, atol=0)
    want = float(np.mean((preds.astype(np.float32) - target.astype(np.float32)) ** 2))
    np.testing.assert_allclose(float(m.compute()), want, rtol=1e-6)


def test_collection_half_is_bfloat16_and_groups_share_again():
    col = mt.MetricCollection(
        {"mse": mt.MeanSquaredError(device="cpu"), "mse2": mt.MeanSquaredError(device="cpu"),
         "mae": mt.MeanAbsoluteError(device="cpu")},
        device="cpu",
    )
    p, t = torch.rand(16, generator=torch.Generator().manual_seed(0)), torch.rand(16, generator=torch.Generator().manual_seed(1))
    col.update(p, t)
    assert col.half() is col
    assert all(m.state[k].dtype == torch.bfloat16 for m in col.values() for k in m.state if m.state[k].is_floating_point())
    assert col["mse2"].sum_squared_error is col["mse"].sum_squared_error
    assert col["mse"].total.dtype == torch.int32
    assert col.double()["mae"].sum_abs_error.dtype == torch.float32


# ------------------------------------------------------------------- grads
def _finite_diff(fn, x, eps=1e-3):
    flat = np.asarray(x, np.float64).ravel()
    grads = np.zeros_like(flat)
    for i in range(flat.size):
        up, down = flat.copy(), flat.copy()
        up[i] += eps
        down[i] -= eps
        grads[i] = (float(fn(up.reshape(x.shape).astype(np.float32))) - float(fn(down.reshape(x.shape).astype(np.float32)))) / (2 * eps)
    return grads.reshape(x.shape)


def _torch_grad(fn, x):
    xt = torch.tensor(x, requires_grad=True)
    (g,) = torch.autograd.grad(fn(xt), xt)
    return g.numpy()


GRAD_CASES = {
    "mean_squared_error": lambda F, p, t: F.mean_squared_error(p, t),
    "mean_absolute_error": lambda F, p, t: F.mean_absolute_error(p, t),
    "mean_squared_log_error": lambda F, p, t: F.mean_squared_log_error(p, t),
    "mean_absolute_percentage_error": lambda F, p, t: F.mean_absolute_percentage_error(p, t),
    "cosine_similarity": lambda F, p, t: F.cosine_similarity(p.reshape(4, 4), t.reshape(4, 4)),
    "explained_variance": lambda F, p, t: F.explained_variance(p, t),
    "r2_score": lambda F, p, t: F.r2_score(p, t),
    "pearson_corrcoef": lambda F, p, t: F.pearson_corrcoef(p, t),
}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_functional_grad_matches_jax_grad(name):
    rng = np.random.default_rng(5)
    preds = rng.random(16).astype(np.float32) + 0.1
    target = rng.random(16).astype(np.float32) + 0.1
    fn = GRAD_CASES[name]
    got = _torch_grad(lambda p: fn(tf, p, torch.from_numpy(target)), preds)
    want = np.asarray(jax.grad(lambda p: fn(jf, p, jnp.asarray(target)))(jnp.asarray(preds)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_mse_grad_matches_finite_differences():
    preds = _rng.random(8).astype(np.float32)
    target = _rng.random(8).astype(np.float32)
    fn = lambda p: tf.mean_squared_error(torch.as_tensor(p), torch.from_numpy(target))  # noqa: E731
    np.testing.assert_allclose(_torch_grad(fn, preds), _finite_diff(fn, preds), atol=1e-2)


def test_metric_apply_update_apply_compute_differentiable():
    """grad flows through apply_update + apply_compute inside a loss, as jax.grad does."""
    target = _rng.random(16, dtype=np.float32)
    preds = _rng.random(16, dtype=np.float32)
    port_metric = mt.MeanSquaredError(device="cpu")
    ref_metric = jm.MeanSquaredError()

    def port_loss(p):
        state = port_metric.apply_update(port_metric.init_state(), p, torch.from_numpy(target))
        return port_metric.apply_compute(state)

    def ref_loss(p):
        state = ref_metric.apply_update(ref_metric.init_state(), p, jnp.asarray(target))
        return ref_metric.apply_compute(state)

    got = _torch_grad(port_loss, preds)
    want = np.asarray(jax.grad(ref_loss)(jnp.asarray(preds)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert float(port_metric.total) == 0  # the instance's own state is untouched
