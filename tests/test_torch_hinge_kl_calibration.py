"""The port's HingeLoss, KLDivergence and CalibrationError against the JAX package, on the CPU.

The same numpy inputs (made from a seed) go through ``metrics_tpu`` and
``metrics_tpu_torch``.

* Hinge: on scores that are multiples of 1/8 every margin, square and sum
  is exact in float32, so the losses match bitwise; on random scores to
  ``rtol=1e-6`` (float32 sums in another order).  Sample counts are int32
  and bitwise.
* KL divergence: ``rtol=1e-5, atol=1e-6`` (each row is a float32 sum of
  ``x * log(y)`` terms of either sign, and XLA's ``log`` and torch's differ
  in the last bit).
* Calibration error: the bin edges and each confidence's bin bitwise
  (``jnp.linspace`` and ``jnp.searchsorted`` against the port's), the
  per-bin counts bitwise; the errors to ``rtol=1e-5, atol=1e-6``: the
  JAX package sums each bin in float32 (a one-hot matmul), the port in
  float64 rounded once.
* The packed sync blob of the list states (``CalibrationError``,
  ``KLDivergence(reduction="none")``) and of one-vs-all hinge's ``(C,)``
  ``measure`` equals the JAX package's byte for byte (KL's rows once the
  JAX package's are loaded: they differ from the port's in the last bit).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.functional as jf
import metrics_tpu.parallel as jp
import metrics_tpu_torch as mt
import metrics_tpu_torch.functional as tf
import metrics_tpu_torch.parallel as tp
from metrics_tpu.functional.classification.calibration_error import _ce_compute as jax_ce_compute
from metrics_tpu.functional.classification.calibration_error import _ce_update as jax_ce_update
from metrics_tpu.functional.classification.hinge import _hinge_update as jax_hinge_update
from metrics_tpu.functional.classification.kl_divergence import _kld_update as jax_kld_update
from metrics_tpu_torch.functional.classification.calibration_error import (
    _bin_edges,
    _bin_indices,
    _ce_compute,
    _ce_update,
)
from metrics_tpu_torch.functional.classification.hinge import _hinge_update
from metrics_tpu_torch.functional.classification.kl_divergence import _kld_update
from metrics_tpu_torch.utils.data import dim_zero_cat
from tests.test_torch_buffer_states import _recording

EAGER = {"jit_update": False, "jit_compute": False}
N, C = 64, 5
KL_TOL = dict(rtol=1e-5, atol=1e-6)
CE_TOL = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_bitwise(port, ref) -> None:
    got, want = _np(port), _np(ref)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), (got, want)


def assert_close(port, ref, rtol=1e-6, atol=0.0) -> None:
    got, want = _np(port), _np(ref)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, equal_nan=True)


# -------------------------------------------------------------------- hinge
def _hinge_inputs(case: str, dyadic: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    shape = (N,) if case == "binary" else (N, C)
    scores = (rng.integers(-24, 25, shape) / 8) if dyadic else rng.standard_normal(shape) * 2
    target = rng.integers(0, 2 if case == "binary" else C, N)
    if case == "out_of_range":  # labels past either end: an all-zero one-hot row, as jax.nn.one_hot gives
        target[:6] = (C, -1, C + 3, -7, C, 2 * C)
    return scores.astype(np.float32), target


HINGE_MODES = [None, "crammer-singer", "one-vs-all"]


@pytest.mark.parametrize("dyadic", [True, False], ids=["dyadic", "random"])
@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("mode", HINGE_MODES, ids=str)
@pytest.mark.parametrize("case", ["binary", "multiclass", "out_of_range"])
def test_hinge_matches_jax(case, mode, squared, dyadic):
    preds, target = _hinge_inputs(case, dyadic)
    ref_measure, ref_total = jax_hinge_update(jnp.asarray(preds), jnp.asarray(target), squared, mode)
    measure, total = _hinge_update(torch.from_numpy(preds), torch.from_numpy(target), squared, mode)
    assert_bitwise(total, ref_total)
    (assert_bitwise if dyadic else assert_close)(measure, ref_measure)
    loss = tf.hinge_loss(torch.from_numpy(preds), torch.from_numpy(target), squared=squared, multiclass_mode=mode)
    (assert_bitwise if dyadic else assert_close)(
        loss, jf.hinge_loss(jnp.asarray(preds), jnp.asarray(target), squared=squared, multiclass_mode=mode))


def test_hinge_rejects_what_jax_rejects():
    preds, target = _hinge_inputs("multiclass", True)
    for args in ((preds, target, False, "one-vs-one"), (preds[:, :, None], target), (preds, target[:, None].repeat(2, 1)),
                 (preds[:10], target)):
        with pytest.raises(ValueError):
            jax_hinge_update(*map(jnp.asarray, args[:2]), *args[2:])
        with pytest.raises(ValueError):
            _hinge_update(*map(torch.from_numpy, args[:2]), *args[2:])
    with pytest.raises(ValueError):
        mt.HingeLoss(multiclass_mode="one-vs-one", device="cpu")


def test_one_vs_all_measure_grows_from_a_scalar_like_jax():
    """``measure`` is a scalar until the first one-vs-all update makes it ``(C,)``;
    ``reset()`` makes it a scalar again.  The shape shows in ``state_pytree``
    and in the schema the sync preflight exchanges."""
    ref = jm.HingeLoss(multiclass_mode="one-vs-all", **EAGER)
    port = mt.HingeLoss(multiclass_mode="one-vs-all", device="cpu")
    assert port._schema_entries() == ref._schema_entries() == [("measure", "sum:():float32"), ("total", "sum:():int32")]
    for seed in (1, 2):
        preds, target = _hinge_inputs("multiclass", True, seed)
        assert_bitwise(port(torch.from_numpy(preds), torch.from_numpy(target)), ref(jnp.asarray(preds), jnp.asarray(target)))
        for name, value in ref.state_pytree().items():
            if name != "_update_count":
                assert_bitwise(port.state_pytree()[name], value)
    assert tuple(port.measure.shape) == (C,)
    assert port._schema_entries() == ref._schema_entries() == [("measure", f"sum:({C},):float32"), ("total", "sum:():int32")]
    assert_bitwise(port.compute(), ref.compute())
    port.reset()
    ref.reset()
    assert tuple(port.measure.shape) == tuple(np.shape(ref.measure)) == ()
    assert port.measure.dtype == torch.float32 and port.total.dtype == torch.int32


# ----------------------------------------------------------------------- KL
def _distributions(seed: int = 0, zeros: bool = False):
    rng = np.random.default_rng(seed)
    p = rng.random((N, C)).astype(np.float32)
    q = rng.random((N, C)).astype(np.float32)
    if zeros:  # 0 * log(0 / q) := 0, and 0 * log(0 / 0) too
        p[::3, 1] = 0.0
        q[::6, 1] = 0.0
    return p, q


@pytest.mark.parametrize("reduction", ["mean", "sum", "none", None], ids=str)
@pytest.mark.parametrize("log_prob", [False, True])
@pytest.mark.parametrize("zeros", [False, True], ids=["positive", "zeros"])
def test_kl_divergence_matches_jax(zeros, log_prob, reduction):
    p, q = _distributions(zeros=zeros)
    if log_prob:
        with np.errstate(divide="ignore"):
            p, q = np.log(p / p.sum(1, keepdims=True)), np.log(q / q.sum(1, keepdims=True))
        # with zeros, a -inf log-probability in q gives an inf row, one in p (exp(-inf) * -inf) a NaN row, in both
    ref = jf.kl_divergence(jnp.asarray(p), jnp.asarray(q), log_prob=log_prob, reduction=reduction)
    got = tf.kl_divergence(torch.from_numpy(p), torch.from_numpy(q), log_prob=log_prob, reduction=reduction)
    assert_close(got, ref, **KL_TOL)
    ref_rows, ref_total = jax_kld_update(jnp.asarray(p), jnp.asarray(q), log_prob)
    rows, total = _kld_update(torch.from_numpy(p), torch.from_numpy(q), log_prob)
    assert_bitwise(total, ref_total)
    assert_close(rows, ref_rows, **KL_TOL)


def test_kl_divergence_rejects_what_jax_rejects():
    p, q = _distributions()
    for a, b in ((p, q[:, :3]), (p[0], q[0])):
        with pytest.raises((ValueError, RuntimeError)) as jax_err:
            jf.kl_divergence(jnp.asarray(a), jnp.asarray(b))
        with pytest.raises(jax_err.type):
            tf.kl_divergence(torch.from_numpy(a), torch.from_numpy(b))
    with pytest.raises(ValueError):
        jf.kl_divergence(jnp.asarray(p), jnp.asarray(q), reduction="max")
    with pytest.raises(ValueError):
        tf.kl_divergence(torch.from_numpy(p), torch.from_numpy(q), reduction="max")
    with pytest.raises(TypeError):
        mt.KLDivergence(log_prob=1, device="cpu")
    with pytest.raises(ValueError):
        mt.KLDivergence(reduction="max", device="cpu")


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_kl_module_streams_like_jax(reduction):
    ref = jm.KLDivergence(reduction=reduction, **EAGER)
    port = mt.KLDivergence(reduction=reduction, device="cpu")
    for seed in (3, 4, 5):
        p, q = _distributions(seed)
        assert_close(port(torch.from_numpy(p), torch.from_numpy(q)), ref(jnp.asarray(p), jnp.asarray(q)), **KL_TOL)
    if reduction == "none":
        assert isinstance(port.measures, list) and len(port.measures) == 3
    else:
        assert port.measures.dtype == torch.float32 and port.measures.ndim == 0
    assert_bitwise(port.total, ref.total)
    assert_close(port.compute(), ref.compute(), **KL_TOL)


# -------------------------------------------------------------- calibration
@pytest.mark.parametrize("n_bins", [1, 2, 10, 15, 41, 42, 48, 100, 1000])
def test_bin_edges_equal_jnp_linspace_bitwise(n_bins):
    assert_bitwise(_bin_edges(n_bins, torch.device("cpu")), jnp.linspace(0, 1, n_bins + 1, dtype=jnp.float32))


def _edge_confidences(n_bins: int, seed: int = 0) -> np.ndarray:
    """Every edge, NaN of either sign, signed zeros, values past either end, and random ones."""
    edges = np.asarray(jnp.linspace(0, 1, n_bins + 1, dtype=jnp.float32))
    rng = np.random.default_rng(seed)
    special = [np.nan, np.copysign(np.nan, -1), -0.0, 0.0, 1.0, 1.5, -0.5, np.inf, -np.inf]
    return np.concatenate([edges, np.nextafter(edges, 2), np.nextafter(edges, -2), special,
                           rng.random(200)]).astype(np.float32)


@pytest.mark.parametrize("n_bins", [1, 10, 15, 42])
def test_bin_indices_equal_jax_bitwise(n_bins):
    conf = _edge_confidences(n_bins)
    edges = jnp.linspace(0, 1, n_bins + 1, dtype=jnp.float32)
    want = jnp.clip(jnp.searchsorted(edges, jnp.asarray(conf), side="left") - 1, 0, n_bins - 1)
    got = _bin_indices(torch.from_numpy(conf), _bin_edges(n_bins, torch.device("cpu")))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(torch.bincount(got, minlength=n_bins).numpy(), np.bincount(np.asarray(want), minlength=n_bins))


def _ce_inputs(case: str, seed: int = 0, specials: bool = False):
    rng = np.random.default_rng(seed)
    if case == "binary":
        preds, target = rng.random(N), rng.integers(0, 2, N)
    elif case == "multiclass":
        logits = rng.standard_normal((N, C))
        preds, target = np.exp(logits) / np.exp(logits).sum(1, keepdims=True), rng.integers(0, C, N)
    else:  # multi-dim multi-class
        logits = rng.standard_normal((N, C, 3))
        preds, target = np.exp(logits) / np.exp(logits).sum(1, keepdims=True), rng.integers(0, C, (N, 3))
    preds = preds.astype(np.float32)
    if specials:
        flat = preds.reshape(-1)
        flat[[1, 7, 30]] = np.nan  # the first NaN of a row wins its argmax and its max
        flat[[2, 11]] = -0.0
        flat[[3, 12]] = 0.0
        flat[[4, 5, 13]] = (0.2, 0.6, 1.0)  # on bin edges of 5, 10 and 15 bins
    return preds, target


@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
@pytest.mark.parametrize("specials", [False, True], ids=["plain", "nan_zero_edges"])
@pytest.mark.parametrize("case", ["binary", "multiclass", "mdmc"])
def test_calibration_error_matches_jax(case, specials, norm):
    preds, target = _ce_inputs(case, specials=specials)
    ref_conf, ref_acc = jax_ce_update(jnp.asarray(preds), jnp.asarray(target))
    conf, acc = _ce_update(torch.from_numpy(preds), torch.from_numpy(target))
    assert_bitwise(conf, ref_conf)  # the top-1 confidence (the first NaN, then the first maximum)
    assert_bitwise(acc, ref_acc)
    for n_bins in (5, 15):
        ref = jf.calibration_error(jnp.asarray(preds), jnp.asarray(target), n_bins=n_bins, norm=norm)
        got = tf.calibration_error(torch.from_numpy(preds), torch.from_numpy(target), n_bins=n_bins, norm=norm)
        assert_close(got, ref, **CE_TOL)


@pytest.mark.parametrize("debias", [False, True])
def test_l2_debias_matches_jax(debias):
    preds, target = _ce_inputs("multiclass", seed=1)
    conf, acc = _ce_update(torch.from_numpy(preds), torch.from_numpy(target))
    edges = jnp.linspace(0, 1, 11, dtype=jnp.float32)
    ref = jax_ce_compute(jnp.asarray(conf.numpy()), jnp.asarray(acc.numpy()), edges, norm="l2", debias=debias)
    got = _ce_compute(conf, acc, _bin_edges(10, torch.device("cpu")), norm="l2", debias=debias)
    assert_close(got, ref, **CE_TOL)


def test_calibration_error_rejects_what_jax_rejects():
    preds, target = _ce_inputs("multiclass")
    multilabel = (preds, (preds > 0.2).astype(np.int64))
    with pytest.raises(ValueError):
        jf.calibration_error(*map(jnp.asarray, multilabel))
    with pytest.raises(ValueError):
        tf.calibration_error(*map(torch.from_numpy, multilabel))
    for kwargs in (dict(norm="l3"), dict(n_bins=0), dict(n_bins=2.5)):
        with pytest.raises(ValueError):
            jf.calibration_error(jnp.asarray(preds), jnp.asarray(target), **kwargs)
        with pytest.raises(ValueError):
            tf.calibration_error(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
        with pytest.raises(ValueError):
            mt.CalibrationError(device="cpu", **kwargs)


@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
def test_calibration_module_streams_like_jax(norm):
    ref = jm.CalibrationError(n_bins=10, norm=norm, **EAGER)
    port = mt.CalibrationError(n_bins=10, norm=norm, device="cpu")
    assert_bitwise(port.bin_boundaries, ref.bin_boundaries)
    for seed in (6, 7, 8):
        preds, target = _ce_inputs("multiclass", seed, specials=seed == 7)
        assert_close(port(torch.from_numpy(preds), torch.from_numpy(target)), ref(jnp.asarray(preds), jnp.asarray(target)), **CE_TOL)
    assert isinstance(port.confidences, list) and len(port.confidences) == 3
    for name in ("confidences", "accuracies"):
        assert_bitwise(port.state_pytree()[name], ref.state_pytree()[name])
    assert_close(port.compute(), ref.compute(), **CE_TOL)


# -------------------------------------------------------------------- sync
SYNC_CASES = {
    "calibration": (lambda pkg, **kw: pkg.CalibrationError(n_bins=10, **kw), lambda s: _ce_inputs("multiclass", s)),
    "kl_none": (lambda pkg, **kw: pkg.KLDivergence(reduction="none", **kw), lambda s: _distributions(s)),
    "hinge_one_vs_all": (lambda pkg, **kw: pkg.HingeLoss(multiclass_mode="one-vs-all", **kw),
                         lambda s: _hinge_inputs("multiclass", True, s)),
}


@pytest.mark.parametrize("name", SYNC_CASES)
def test_packed_sync_blob_equals_the_jax_package(name):
    make, inputs = SYNC_CASES[name]
    jb, tb = _recording(jp), _recording(tp)
    ref, port = make(jm, sync_backend=jb, **EAGER), make(mt, sync_backend=tb, device="cpu")
    for seed in (9, 10):
        a, b = inputs(seed)
        ref.update(jnp.asarray(a), jnp.asarray(b))
        port.update(torch.from_numpy(a), torch.from_numpy(b))
    if name == "kl_none":
        # each row's divergence differs from the JAX package's in the last bit (XLA's log and torch's);
        # with the JAX package's rows loaded, the blob must be its blob byte for byte
        assert_close(dim_zero_cat(port.measures), jnp.concatenate(ref.measures), **KL_TOL)
        mt.load_jax_state(port, ref.state_pytree())
    assert port._schema_entries() == ref._schema_entries()
    np.testing.assert_array_equal(tp.schema_digest_rows(port._schema_entries()), jp.schema_digest_rows(ref._schema_entries()))
    got, want = port.compute(), ref.compute()
    assert len(tb.blobs) == len(jb.blobs) == 1 and tb.blobs == jb.blobs
    for key in ("gather_calls", "bytes_gathered", "preflight_calls", "preflight_bytes"):
        assert port.last_sync_report[key] == ref.last_sync_report[key], key
    assert_bitwise(got, want) if name != "calibration" else assert_close(got, want, **CE_TOL)
