"""The port's pure state API and wrappers against the JAX package.

Inputs are made from a seed with numpy and fed to both packages.  Tolerances:

* bitwise: the pure API's states, the resample draws, the copies' rows and
  ``_replica_rows``, every integer count, and the values of copies fed with
  multiples of 1/8 (every sum exact, one rounding in the score);
* ``R * U`` absolute, ``U = 2**-24``, for the mean of ``R`` copies' values in
  [0, 1] (the sum adds in another order), and ``8 * R * U`` for ``std``
  and ``quantile`` (their moments cancel);
* ``AUC_RTOL`` for AUROC copies, as ``tests/test_torch_curves.py`` holds the
  exact curves.
"""

import pickle
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import metrics_tpu as jm
import metrics_tpu_torch as mt
from metrics_tpu.streaming.sketches import bootstrap_resample_indices as jax_resample
from metrics_tpu_torch.interop import load_jax_state
from metrics_tpu_torch.wrappers._resample import bootstrap_resample_indices, stacked_poisson_draws

U = 2.0**-24
AUC_RTOL = 1e-6
N, C, R = 16, 4, 8
EAGER = {"jit_update": False, "jit_compute": False}


def _eighths(rng, *shape):
    return (rng.integers(-16, 17, shape) / 8).astype(np.float32)


def _batches(seed: int, n_batches: int = 3, size: int = N):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        probs = rng.random((size, C)).astype(np.float32)
        probs /= probs.sum(1, keepdims=True)
        out.append({
            "x": _eighths(rng, size), "y": _eighths(rng, size),
            "probs": probs, "labels": rng.integers(0, C, size),
        })
    return out


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _same(a, b, key=""):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (key, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), (key, a, b)


# name -> (JAX factory, port factory, input keys); the first two the JAX package stacks, the others it does
# not whether or not they trace (a buffer state; a host NaN check), so those run eager: the copies' resamples
# vary in length, and a traced update would compile once per length
BASES = {
    "mse": (lambda: jm.MeanSquaredError(), lambda: mt.MeanSquaredError(device="cpu"), ("x", "y")),
    "accuracy": (lambda: jm.Accuracy(num_classes=C), lambda: mt.Accuracy(num_classes=C, device="cpu"), ("probs", "labels")),
    "auroc": (lambda: jm.AUROC(num_classes=C, **EAGER), lambda: mt.AUROC(num_classes=C, device="cpu"), ("probs", "labels")),
    "mean": (lambda: jm.MeanMetric(**EAGER), lambda: mt.MeanMetric(device="cpu"), ("x",)),
}
STACKED = {"mse": True, "accuracy": True, "auroc": False, "mean": False}


def _args(batch, keys, pkg):
    return [jnp.asarray(batch[k]) if pkg == "jax" else torch.from_numpy(batch[k]) for k in keys]


# ------------------------------------------------------------------ pure state API
def test_init_state_holds_fresh_defaults_and_python_int_counts():
    m = mt.AUROC(num_classes=C, device="cpu")
    state = m.init_state()
    assert state["preds__len"] == 0 and isinstance(state["preds__len"], int)
    assert state["preds__buf"] is not m._defaults["preds__buf"]
    assert mt.CatMetric(device="cpu").init_state() == {"value": []}
    jstate = jm.MeanSquaredError().init_state()
    for name, value in mt.MeanSquaredError(device="cpu").init_state().items():
        _same(value, jstate[name], name)


@pytest.mark.parametrize("name", ["mse", "accuracy", "auroc"])
def test_apply_update_leaves_the_instance_alone_and_equals_jax(name):
    make_jax, make_port, keys = BASES[name]
    b0, b1 = _batches(0, 2)
    port, ref = make_port(), make_jax()
    port.update(*_args(b0, keys, "torch"))
    own = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in port._copy_state().items()}
    state = port.apply_update(port._copy_state(), *_args(b1, keys, "torch"))
    for key, value in port._copy_state().items():
        _same(value, own[key], key)
    assert port.update_count == 1
    jstate = ref.apply_update(ref.apply_update(ref.init_state(), *_args(b0, keys, "jax")), *_args(b1, keys, "jax"))
    if name == "auroc":
        for key in ("preds", "target"):
            _same(state[key + "__buf"][: state[key + "__len"]], np.asarray(jstate[key + "__buf"])[: jstate[key + "__len"]], key)
        assert isinstance(state["preds__len"], int)
    else:
        for key, value in state.items():
            _same(value, jstate[key], key)
    # the instance goes on from its own state; the pure result keeps its rows
    port.update(*_args(b0, keys, "torch"))
    again = port.apply_compute(state)
    want = np.asarray(ref.apply_compute(jstate))
    np.testing.assert_allclose(_np(again), want, rtol=AUC_RTOL if name == "auroc" else 0)


def test_apply_update_of_a_list_state_does_not_append_to_the_given_list():
    m = mt.CatMetric(device="cpu")
    state = m.init_state()
    new = m.apply_update(state, torch.tensor([1.0, 2.0]))
    assert state["value"] == [] and len(new["value"]) == 1 and m.value == []


def test_apply_compute_over_an_axis_names_ddp(tmp_path):
    """``apply_compute(state, axis_name=)`` syncs the state over the axis (an
    ``AxisBackend`` over the default process group) and returns the all-rank
    value: in a gloo world of one, the rank's own value, bitwise the JAX
    package's on the same rows (multi-rank worlds: ``tests/test_torch_mesh_parity.py``)."""
    rng = np.random.default_rng(5)
    p, t = _eighths(rng, 64), _eighths(rng, 64)
    m = mt.MeanSquaredError(device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        state = m.apply_update(m.init_state(), torch.from_numpy(p), torch.from_numpy(t))
        got = m.apply_compute(state, axis_name="data")
        with mt.parallel.axis_context("data"):
            assert isinstance(mt.parallel.get_backend(), mt.parallel.AxisBackend)
            ambient = m.apply_compute(state, axis_name="data")
    finally:
        dist.destroy_process_group()
    ref = jm.MeanSquaredError()
    want = np.asarray(ref.apply_compute(ref.apply_update(ref.init_state(), jnp.asarray(p), jnp.asarray(t))))
    assert _np(got).tobytes() == want.tobytes() == _np(ambient).tobytes()


# ------------------------------------------------------------------ draws
@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
@pytest.mark.parametrize("size", [1, 7, 40])
def test_resample_indices_equal_the_jax_package(strategy, size):
    got = bootstrap_resample_indices(np.random.default_rng(3), size, 5, strategy)
    want = jax_resample(np.random.default_rng(3), size, 5, strategy)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("size", [1, 3, 8, 50])
def test_stacked_poisson_draws_are_the_jax_routes_draws(size):
    """The JAX route's cap and draws (``bootstrapping.py:235-238``), replayed on a twin generator."""
    counts, idx = stacked_poisson_draws(np.random.default_rng(5), size, 6)
    rng = np.random.default_rng(5)
    chunk = min(8, size)
    cap = -(-(size + 5 * int(np.ceil(np.sqrt(size))) + 10) // chunk) * chunk
    assert idx.shape == (6, cap)
    assert np.array_equal(counts, np.minimum(rng.poisson(size, 6), cap).astype(np.int32))
    assert np.array_equal(idx, rng.integers(0, size, size=(6, cap)))


@pytest.mark.parametrize("name", list(BASES))
def test_the_port_draws_by_the_route_the_jax_package_takes(name):
    make_jax, make_port, keys = BASES[name]
    batch = _batches(1, 1)[0]
    ref = jm.BootStrapper(make_jax(), num_bootstraps=3, seed=1)
    port = mt.BootStrapper(make_port(), num_bootstraps=3, seed=1, device="cpu")
    ref.update(*_args(batch, keys, "jax"))
    port.update(*_args(batch, keys, "torch"))
    assert ref._vmap_active is STACKED[name] and port._stacked is STACKED[name]


ROUTE_ONLY = {  # more bases whose route the JAX package decides by the same facts; none of them demotes there
    "pearson": (lambda: jm.PearsonCorrCoef(), lambda: mt.PearsonCorrCoef(device="cpu"), ("x", "y"), True),
    "kl": (lambda: jm.KLDivergence(), lambda: mt.KLDivergence(device="cpu"), ("probs", "probs"), True),
    "calibration": (lambda: jm.CalibrationError(**EAGER), lambda: mt.CalibrationError(device="cpu"), ("probs", "labels"), False),
    "spearman": (lambda: jm.SpearmanCorrCoef(**EAGER), lambda: mt.SpearmanCorrCoef(device="cpu"), ("x", "y"), False),
}


@pytest.mark.parametrize("name", list(ROUTE_ONLY))
def test_more_bases_draw_by_the_jax_route(name):
    make_jax, make_port, keys, stacked = ROUTE_ONLY[name]
    batch = _batches(1, 1)[0]
    ref = jm.BootStrapper(make_jax(), num_bootstraps=3, seed=1)
    port = mt.BootStrapper(make_port(), num_bootstraps=3, seed=1, device="cpu")
    ref.update(*_args(batch, keys, "jax"))
    port.update(*_args(batch, keys, "torch"))
    assert ref._vmap_active is stacked and port._stacked is stacked


def test_every_wrapper_of_the_jax_package_is_exported():
    import metrics_tpu.wrappers as jw
    import metrics_tpu_torch.wrappers as tw

    assert set(jw.__all__) <= set(tw.__all__) <= set(mt.__all__)
    for name in jw.__all__:
        assert getattr(mt, name) is getattr(tw, name)


def test_a_host_checked_aggregator_is_not_stacked():
    assert mt.MeanMetric(device="cpu").traced_update is False
    assert mt.MeanMetric(nan_strategy="ignore", device="cpu").traced_update is True


# ------------------------------------------------------------------ BootStrapper
def _run_boot(name, strategy, seed, batches, **kwargs):
    make_jax, make_port, keys = BASES[name]
    ref = jm.BootStrapper(make_jax(), num_bootstraps=R, sampling_strategy=strategy, seed=seed, **kwargs)
    port = mt.BootStrapper(make_port(), num_bootstraps=R, sampling_strategy=strategy, seed=seed, device="cpu", **kwargs)
    for batch in batches:
        ref.update(*_args(batch, keys, "jax"))
        port.update(*_args(batch, keys, "torch"))
    return ref, port


def _check_stats(name, got, want):
    assert sorted(got) == sorted(want)
    rtol = AUC_RTOL if name == "auroc" else 0.0
    if "raw" in got:
        np.testing.assert_allclose(_np(got["raw"]), np.asarray(want["raw"]), rtol=rtol, atol=0)
        if rtol == 0:
            _same(got["raw"], want["raw"], "raw")
    n = _np(got["raw"]).shape[0] if "raw" in got else R
    for key, atol in (("mean", n * U), ("std", 8 * n * U), ("quantile", 8 * n * U)):
        if key in got:
            np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]), rtol=rtol, atol=atol, err_msg=key)


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
@pytest.mark.parametrize("name", list(BASES))
def test_bootstrapper_matches_jax_on_both_routes(name, strategy):
    ref, port = _run_boot(name, strategy, 7, _batches(2), quantile=[0.1, 0.5, 0.9], raw=True)
    if port._stacked and strategy == "poisson":
        assert np.array_equal(port._replica_rows, ref._replica_rows)
    _check_stats(name, port.compute(), ref.compute())


@pytest.mark.parametrize("name", ["mse", "mean"])
def test_empty_poisson_copies_stay_out_of_the_statistics(name):
    """Batches of one row: a copy draws no row with probability 1/e per batch."""
    batches = _batches(4, n_batches=2, size=1)
    ref, port = _run_boot(name, "poisson", 11, batches, raw=True)
    got, want = port.compute(), ref.compute()
    fed = sum(m._update_count > 0 for m in port.metrics)
    assert 0 < fed < R and _np(got["raw"]).shape == (fed,)
    if name == "mse":
        assert np.array_equal(port._replica_rows, ref._replica_rows) and (port._replica_rows == 0).sum() == R - fed
    _check_stats(name, got, want)


def test_bootstrapper_forward_reset_and_pickle():
    batches = _batches(5)
    make_jax, make_port, keys = BASES["accuracy"]
    ref = jm.BootStrapper(make_jax(), num_bootstraps=R, seed=2, raw=True)
    port = mt.BootStrapper(make_port(), num_bootstraps=R, seed=2, raw=True, device="cpu")
    for batch in batches[:2]:
        _check_stats("accuracy", port(*_args(batch, keys, "torch")), ref(*_args(batch, keys, "jax")))
    clone = pickle.loads(pickle.dumps(port))
    for m in (port, clone):
        m.update(*_args(batches[2], keys, "torch"))
    ref.update(*_args(batches[2], keys, "jax"))
    _same(clone.compute()["raw"], port.compute()["raw"])
    _check_stats("accuracy", port.compute(), ref.compute())
    port.reset()  # re-seeds: the next epoch draws as the first did
    ref.reset()
    port.update(*_args(batches[0], keys, "torch"))
    ref.update(*_args(batches[0], keys, "jax"))
    _check_stats("accuracy", port.compute(), ref.compute())


def test_bootstrapper_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="sampling_strategy"):
        mt.BootStrapper(mt.MeanSquaredError(device="cpu"), sampling_strategy="x", device="cpu")
    with pytest.raises(ValueError, match="base metric"):
        mt.BootStrapper(object(), device="cpu")


@pytest.mark.parametrize("name", ["mse", "mean"])
def test_bootstrapper_loaded_mid_stream_from_jax_finishes_equal(name):
    """The JAX wrapper's copies (stacked or not), ``_replica_rows`` and generator go across."""
    make_jax, make_port, keys = BASES[name]
    batches = _batches(6, n_batches=4)
    ref = jm.BootStrapper(make_jax(), num_bootstraps=R, seed=9, raw=True)
    for batch in batches[:2]:
        ref.update(*_args(batch, keys, "jax"))
    port = mt.BootStrapper(make_port(), num_bootstraps=R, seed=123, raw=True, device="cpu")
    load_jax_state(port, {
        "_update_count": ref._update_count,
        "_stacked_state": ref._stacked_state,
        "replicas": [m.state_pytree() for m in ref.metrics],
        "_replica_rows": ref._replica_rows,
        "rng": ref._rng.bit_generator.state,
    }, [m._ckpt_extra_state() for m in ref.metrics])
    assert (ref._stacked_state is not None) is STACKED[name]
    for batch in batches[2:]:
        ref.update(*_args(batch, keys, "jax"))
        port.update(*_args(batch, keys, "torch"))
    _check_stats(name, port.compute(), ref.compute())


# ------------------------------------------------------------------ the other wrappers
def test_classwise_wrapper_matches_jax_and_pickles():
    batches = _batches(7)
    labels = ["a", "b", "c", "d"]
    ref = jm.ClasswiseWrapper(jm.Accuracy(num_classes=C, average=None), labels=labels)
    port = mt.ClasswiseWrapper(mt.Accuracy(num_classes=C, average=None, device="cpu"), labels=labels, device="cpu")
    for batch in batches[:2]:
        got, want = port(*_args(batch, ("probs", "labels"), "torch")), ref(*_args(batch, ("probs", "labels"), "jax"))
        assert list(got) == list(want) == [f"accuracy_{lab}" for lab in labels]
        for key in want:
            _same(got[key], want[key], key)
    clone = pickle.loads(pickle.dumps(port))
    clone.update(*_args(batches[2], ("probs", "labels"), "torch"))
    ref.update(*_args(batches[2], ("probs", "labels"), "jax"))
    for key, value in ref.compute().items():
        _same(clone.compute()[key], value, key)
    port.reset()
    assert port.metric.update_count == 0
    assert list(mt.ClasswiseWrapper(mt.Accuracy(num_classes=2, average=None, device="cpu"), device="cpu")._convert(torch.zeros(2))) == ["accuracy_0", "accuracy_1"]
    with pytest.raises(ValueError, match="labels"):
        mt.ClasswiseWrapper(mt.Accuracy(num_classes=2, device="cpu"), labels="ab", device="cpu")


def test_minmax_forward_gives_the_batch_value_and_tracks_extremes():
    batches = _batches(8)
    keys = ("probs", "labels")
    ref = jm.MinMaxMetric(jm.Accuracy(num_classes=C))
    port = mt.MinMaxMetric(mt.Accuracy(num_classes=C, device="cpu"), device="cpu")
    for batch in batches:
        got, want = port(*_args(batch, keys, "torch")), ref(*_args(batch, keys, "jax"))
        for key in ("raw", "min", "max"):
            _same(got[key], want[key], key)
    assert port._update_count == ref._update_count == len(batches)
    clone = pickle.loads(pickle.dumps(port))
    for m, r in ((clone, ref), (port, None)):
        out = m.compute()
        if r is not None:
            for key, value in r.compute().items():
                _same(out[key], value, key)
    port.reset()
    assert float(port.min_val) == float("inf") and float(port.max_val) == float("-inf")
    with pytest.raises(RuntimeError, match="scalar"):
        bad = mt.MinMaxMetric(mt.Accuracy(num_classes=C, average=None, device="cpu"), device="cpu")
        bad.update(*_args(batches[0], keys, "torch"))
        bad.compute()


def test_minmax_loaded_mid_stream_from_jax_finishes_equal():
    batches = _batches(9, n_batches=4)
    keys = ("probs", "labels")
    ref = jm.MinMaxMetric(jm.Accuracy(num_classes=C))
    for batch in batches[:2]:
        ref(*_args(batch, keys, "jax"))
    port = mt.MinMaxMetric(mt.Accuracy(num_classes=C, device="cpu"), device="cpu")
    load_jax_state(port, {"_update_count": ref._update_count, "min_val": ref.min_val, "max_val": ref.max_val,
                          "base": ref._base_metric.state_pytree()}, ref._base_metric._ckpt_extra_state())
    for batch in batches[2:]:
        got, want = port(*_args(batch, keys, "torch")), ref(*_args(batch, keys, "jax"))
        for key in ("raw", "min", "max"):
            _same(got[key], want[key], key)
    for key, value in ref.compute().items():
        _same(port.compute()[key], value, key)


def _multioutput_batches(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        preds, target = _eighths(rng, N, 3), _eighths(rng, N, 3)
        preds[rng.random((N, 3)) < 0.1] = np.nan
        target[rng.random((N, 3)) < 0.1] = np.nan
        out.append((preds, target))
    return out


@pytest.mark.parametrize("remove_nans", [True, False])
def test_multioutput_wrapper_strips_nan_rows_per_output_as_jax(remove_nans):
    batches = _multioutput_batches(10)
    ref = jm.MultioutputWrapper(jm.MeanAbsoluteError(**EAGER), num_outputs=3, remove_nans=remove_nans)
    port = mt.MultioutputWrapper(mt.MeanAbsoluteError(device="cpu"), num_outputs=3, remove_nans=remove_nans, device="cpu")
    got = port(*map(torch.from_numpy, batches[0]))
    want = ref(*map(jnp.asarray, batches[0]))
    for g, w in zip(got, want):
        _same(g, w)
    clone = pickle.loads(pickle.dumps(port))
    for preds, target in batches[1:]:
        clone.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    for g, w in zip(clone.compute(), ref.compute()):
        _same(g, w)
    for g, m in zip(clone.metrics, ref.metrics):
        _same(g.total, m._state["total"])
    clone.reset()
    assert all(m.update_count == 0 for m in clone.metrics)


def _tracker_collection(pkg, **kwargs):
    return pkg.MetricCollection(
        {"acc": pkg.Accuracy(num_classes=C, **kwargs), "f1": pkg.F1Score(num_classes=C, average="macro", **kwargs),
         "cm": pkg.ConfusionMatrix(num_classes=C, **kwargs)},
        **({"device": "cpu"} if pkg is mt else {}),
    )


def test_metric_tracker_matches_jax_and_gives_none_for_a_matrix():
    batches = _batches(11, n_batches=3)
    keys = ("probs", "labels")
    ref = jm.MetricTracker(_tracker_collection(jm), maximize=[True, True, True])
    port = mt.MetricTracker(_tracker_collection(mt, device="cpu"), maximize=[True, True, True])
    with pytest.raises(ValueError, match="increment"):
        port.update(*_args(batches[0], keys, "torch"))
    for batch in batches:
        ref.increment()
        port.increment()
        ref.update(*_args(batch, keys, "jax"))
        port.update(*_args(batch, keys, "torch"))
    assert port.n_steps == len(port) == 3
    got_all, want_all = port.compute_all(), ref.compute_all()
    for key, value in want_all.items():
        _same(got_all[key], value, key)
    with pytest.warns(UserWarning, match="not a scalar"):
        value, step = port.best_metric(return_step=True)
    assert value["cm"] is None and step["cm"] is None
    with pytest.raises(IndexError):  # the JAX package indexes the steps with a flat argmax of the matrices
        ref.best_metric(return_step=True)
    for key in ("acc", "f1"):
        arr = np.asarray(want_all[key])
        assert step[key] == int(np.argmax(arr)) and value[key] == float(arr[step[key]])
    port.reset_all()
    assert all(m.update_count == 0 for s in port._steps for m in s.values())


@pytest.mark.parametrize("maximize", [True, False])
def test_metric_tracker_of_one_metric_matches_jax(maximize):
    batches = _batches(12, n_batches=4)
    keys = ("probs", "labels")
    ref = jm.MetricTracker(jm.Accuracy(num_classes=C), maximize=maximize)
    port = mt.MetricTracker(mt.Accuracy(num_classes=C, device="cpu"), maximize=maximize)
    for batch in batches:
        ref.increment()
        port.increment()
        _same(port(*_args(batch, keys, "torch")), ref(*_args(batch, keys, "jax")))
    _same(port.compute(), ref.compute())
    assert port.best_metric(return_step=True) == ref.best_metric(return_step=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port.best_metric()

