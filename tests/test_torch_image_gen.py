"""The port's FID, KID and IS against the JAX package's, and the image queue.

The extractor is a callable that maps an image batch to features that are
multiples of 1/8 (its first ``DIM`` pixel values, shifted and scaled), so
FID's sums and outer products are exact in float32 in any order and every
state compares bitwise.  The values: FID to ``rtol=1e-4`` (two float32
``eigh``s), KID's and IS's means to ``rtol=1e-5`` and their standard
deviations to ``1e-5`` of the mean (a deviation cancels: its error scales
with the values it is taken from).  The built-in extractor runs at the
64 tap on weights carried across (states to the taps' tolerance there).

KID's subset indices and IS's shuffle are the JAX package's draws, bitwise,
at n = 1 (no shuffle round), 1,000 (one) and 2,000 (two).
"""

import warnings

import numpy as np
import pytest
import torch

DIM = 8
FID_RTOL = 1e-4
SCORE_RTOL = 1e-5


def _features_np(imgs):
    flat = np.asarray(imgs).reshape(len(imgs), -1)[:, :DIM].astype(np.int64)
    return ((flat % 16) - 8).astype(np.float32) / 8


def _jax_extractor(imgs):
    import jax.numpy as jnp

    flat = jnp.asarray(imgs).reshape(imgs.shape[0], -1)[:, :DIM].astype(jnp.int32)
    return ((flat % 16) - 8).astype(jnp.float32) / 8


def _port_extractor(imgs):
    flat = torch.as_tensor(imgs).reshape(imgs.shape[0], -1)[:, :DIM].to(torch.int64)
    return ((flat % 16) - 8).to(torch.float32) / 8


def _batches(seed: int, sizes=(5, 3, 7, 4)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(n, 3, 6, 6), dtype=np.uint8) for n in sizes]


def _feed(metric, real, fake, torch_side: bool):
    for r, f in zip(real, fake):
        metric.update(torch.from_numpy(r) if torch_side else r, True)
        metric.update(torch.from_numpy(f) if torch_side else f, False)


def _bits(x) -> bytes:
    return np.ascontiguousarray(np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)).tobytes()


def _close(got, want, rtol, key=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=0, err_msg=key)


def _close_scores(got, want) -> None:
    """KID's or IS's (mean, std) against the JAX package's."""
    (mean, std), (want_mean, want_std) = got, (np.asarray(w) for w in want)
    _close(mean, want_mean, SCORE_RTOL, "mean")
    np.testing.assert_allclose(std.numpy(), want_std, rtol=SCORE_RTOL, atol=SCORE_RTOL * abs(float(want_mean)),
                               err_msg="std")


def _pair(kind: str, **kwargs):
    import metrics_tpu as jm
    import metrics_tpu_torch as mt

    extra = {"feature_dim": DIM} if kind == "FrechetInceptionDistance" else {}
    return (getattr(jm, kind)(feature=_jax_extractor, **extra, **kwargs),
            getattr(mt, kind)(feature=_port_extractor, **extra, **kwargs, device="cpu"))


FID_STATES = ("real_sum", "real_outer", "real_n", "fake_sum", "fake_outer", "fake_n")


@pytest.mark.parametrize("extractor_batch", [None, 4], ids=["per-call", "chunked"])
def test_fid_states_bitwise_and_value(extractor_batch):
    ref, port = _pair("FrechetInceptionDistance", extractor_batch=extractor_batch)
    real, fake = _batches(0), _batches(1)
    _feed(ref, real, fake, False)
    _feed(port, real, fake, True)
    for key in FID_STATES:  # each a direct read, which drains the queue first
        assert _bits(getattr(port, key)) == _bits(getattr(ref, key)), key
    _close(port.compute(), ref.compute(), FID_RTOL)


@pytest.mark.parametrize("extractor_batch", [None, 4], ids=["per-call", "chunked"])
def test_kid_states_bitwise_and_value(extractor_batch):
    ref, port = _pair("KernelInceptionDistance", subsets=6, subset_size=10, extractor_batch=extractor_batch)
    real, fake = _batches(2), _batches(3)
    _feed(ref, real, fake, False)
    _feed(port, real, fake, True)
    for key in ("real_features", "fake_features"):
        got = torch.cat(getattr(port, key))
        want = np.concatenate([np.asarray(v) for v in getattr(ref, key)])
        assert _bits(got) == _bits(want), key
    _close_scores(port.compute(), ref.compute())


@pytest.mark.parametrize("extractor_batch", [None, 4], ids=["per-call", "chunked"])
def test_inception_score_states_bitwise_and_value(extractor_batch):
    import metrics_tpu as jm
    import metrics_tpu_torch as mt

    ref = jm.InceptionScore(feature=_jax_extractor, splits=3, extractor_batch=extractor_batch)
    port = mt.InceptionScore(feature=_port_extractor, splits=3, extractor_batch=extractor_batch, device="cpu")
    for imgs in _batches(4, sizes=(5, 3, 7, 10)):  # 25 rows into 3 splits
        ref.update(imgs)
        port.update(torch.from_numpy(imgs))
    assert _bits(torch.cat(port.features)) == _bits(np.concatenate([np.asarray(v) for v in ref.features]))
    _close_scores(port.compute(), ref.compute())


def test_is_splits_like_array_split_not_chunk():
    import metrics_tpu as jm
    import metrics_tpu_torch as mt

    ref = jm.InceptionScore(feature=_jax_extractor, splits=10)
    port = mt.InceptionScore(feature=_port_extractor, splits=10, device="cpu")
    imgs = _batches(5, sizes=(25,))[0]
    ref.update(imgs)
    port.update(torch.from_numpy(imgs))
    assert [len(c) for c in torch.tensor_split(torch.zeros(25), 10)] == [3] * 5 + [2] * 5
    _close_scores(port.compute(), ref.compute())
    few = mt.InceptionScore(feature=_port_extractor, splits=10, device="cpu")
    few_ref = jm.InceptionScore(feature=_jax_extractor, splits=10)
    few.update(torch.from_numpy(imgs[:4]))
    few_ref.update(imgs[:4])
    _close_scores(few.compute(), few_ref.compute())  # fewer rows than splits: the empty chunks are dropped


@pytest.mark.parametrize("n", [1, 1000, 2000])
def test_subset_indices_and_the_shuffle_are_the_jax_draws(n):
    import jax

    from metrics_tpu_torch.image.kid import kid_subsets
    from metrics_tpu_torch.streaming import _threefry

    subsets, size = 3, min(n, 700)
    k_real, k_fake = jax.random.split(jax.random.PRNGKey(17))  # as KID.compute draws them
    want_real = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n)[:size])(jax.random.split(k_real, subsets)))
    want_fake = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n + 1)[:size])(jax.random.split(k_fake, subsets)))
    got_real, got_fake = kid_subsets(17, subsets, size, n, n + 1)
    assert got_real.dtype == torch.int64 and np.array_equal(got_real.numpy(), want_real)
    assert np.array_equal(got_fake.numpy(), want_fake)
    want_perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(42), n))
    assert np.array_equal(_threefry.permutation(_threefry.seed(42), n).numpy(), want_perm)


def _inception_variables(seed: int) -> dict:
    """The JAX Inception's variables tree, laid out by ``eval_shape`` of its init and filled from numpy."""
    import jax
    import jax.numpy as jnp

    from metrics_tpu.image.backbones.inception import FlaxInceptionV3

    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(FlaxInceptionV3().init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 299, 299, 3), jnp.float32))

    def walk(tree):
        return {k: walk(v) if hasattr(v, "items") else
                (rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:-1]))).astype(np.float32) if k == "kernel"
                else rng.uniform(0.5, 1.5, v.shape).astype(np.float32) for k, v in tree.items()}

    return walk(shapes)


def test_the_builtin_extractor_at_the_64_tap():
    import metrics_tpu as jm
    import metrics_tpu_torch as mt

    variables = _inception_variables(seed=6)
    real, fake = _batches(7, sizes=(6, 6)), _batches(8, sizes=(6, 6))  # one batch shape: one JAX compile
    ref = jm.FrechetInceptionDistance(feature=64, inception_params=variables)
    port = mt.FrechetInceptionDistance(feature=64, inception_params=variables, device="cpu")
    _feed(ref, real, fake, False)
    _feed(port, real, fake, True)
    for key in FID_STATES:  # the taps' tolerance: the features differ in their float32 roundings
        np.testing.assert_allclose(getattr(port, key).numpy(), np.asarray(getattr(ref, key)), rtol=1e-4, atol=1e-5,
                                   err_msg=key)
    # no value check here: 12 samples in 64 dimensions give singular covariances, whose clamped
    # spectra turn float32 roundings into noise of the value (full-rank values: the tests above and below)


@pytest.mark.parametrize("dim", [16, 64])
def test_the_fid_formula_on_full_rank_covariances(dim):
    import jax.numpy as jnp

    from metrics_tpu.image.fid import _compute_fid as jax_fid
    from metrics_tpu_torch.image.fid import _compute_fid

    rng = np.random.default_rng(dim)
    parts = []
    for _ in range(2):
        a = rng.standard_normal((dim, dim))
        parts += [rng.standard_normal(dim).astype(np.float32), (a @ a.T / dim + 0.1 * np.eye(dim)).astype(np.float32)]
    want = jax_fid(*(jnp.asarray(p) for p in parts))
    _close(_compute_fid(*(torch.from_numpy(p) for p in parts)), want, FID_RTOL)


def test_the_queue_chunks_copies_and_drains():
    import metrics_tpu_torch as mt
    from metrics_tpu_torch.image._batching import ChunkedImageQueue

    seen = []

    def spy(imgs):
        seen.append(int(imgs.shape[0]))
        return _port_extractor(imgs)

    m = mt.FrechetInceptionDistance(feature=spy, feature_dim=DIM, extractor_batch=4, device="cpu")
    real = _batches(9, sizes=(3, 3, 3))
    m.update(torch.from_numpy(real[0]), True)
    assert seen == [] and m._host_buffers_dirty and "real_n" not in m.__dict__
    m.update(torch.from_numpy(real[1]), True)
    m.update(torch.from_numpy(real[2][:0]), True)  # an empty batch leaves the queue as it was
    assert seen == [4]
    assert float(m.real_n) == 6.0 and seen == [4, 2]  # a direct read drains the partial chunk
    m.update(torch.from_numpy(real[2]), True)
    assert float(m.state["real_n"]) == 9.0 and seen == [4, 2, 3]
    queue = ChunkedImageQueue(2)
    batch = np.arange(6, dtype=np.uint8).reshape(3, 2)
    assert [c.tolist() for c in queue.push("k", batch)] == [[[0, 1], [2, 3]]]
    batch[:] = 99  # a loader reusing its buffer: the queued rows keep the call's values
    assert [c.tolist() for c in queue.drain("k")] == [[[4, 5]]] and not queue.pending


@pytest.mark.parametrize("kind", ["FrechetInceptionDistance", "KernelInceptionDistance"])
def test_reset_keeping_real_features_folds_buffered_reals(kind):
    kwargs = {"subsets": 2, "subset_size": 4} if kind == "KernelInceptionDistance" else {}
    ref, port = _pair(kind, reset_real_features=False, extractor_batch=8, **kwargs)
    real, fake = _batches(10, sizes=(5,)), _batches(11, sizes=(6,))
    _feed(ref, real, fake, False)
    _feed(port, real, fake, True)
    ref.reset()
    port.reset()
    more_real, more_fake = _batches(12, sizes=(3,)), _batches(13, sizes=(7,))
    _feed(ref, more_real, more_fake, False)
    _feed(port, more_real, more_fake, True)
    if kind == "FrechetInceptionDistance":
        for key in FID_STATES:
            assert _bits(getattr(port, key)) == _bits(getattr(ref, key)), key
        _close(port.compute(), ref.compute(), FID_RTOL)
    else:
        assert len(torch.cat(port.real_features)) == 8 and len(torch.cat(port.fake_features)) == 7
        _close_scores(port.compute(), ref.compute())


@pytest.mark.parametrize("extractor_batch", [None, 4], ids=["per-call", "chunked"])
def test_forward_gives_the_batch_value_and_keeps_the_epoch(extractor_batch):
    ref, port = _pair("FrechetInceptionDistance", reset_real_features=False, extractor_batch=extractor_batch)
    real, fake = _batches(14), _batches(15)
    for r, f in zip(real, fake):
        ref.update(r, True)
        port.update(torch.from_numpy(r), True)
        _close(port(torch.from_numpy(f), False), ref(f, False), FID_RTOL)
    for key in FID_STATES:
        assert _bits(getattr(port, key)) == _bits(getattr(ref, key)), key


@pytest.mark.parametrize("kind", ["FrechetInceptionDistance", "KernelInceptionDistance", "InceptionScore"])
def test_load_jax_state_and_pickle(kind):
    import pickle

    import metrics_tpu as jm
    import metrics_tpu_torch as mt
    from metrics_tpu_torch import load_jax_state

    if kind == "InceptionScore":
        ref = jm.InceptionScore(feature=_jax_extractor, splits=2)
        port = mt.InceptionScore(feature=_port_extractor, splits=2, device="cpu")
        for imgs in _batches(16):
            ref.update(imgs)
    else:
        kwargs = {"subsets": 3, "subset_size": 6} if kind == "KernelInceptionDistance" else {}
        ref, port = _pair(kind, **kwargs)
        _feed(ref, _batches(16), _batches(17), False)
    load_jax_state(port, ref.state_pytree())
    clone = pickle.loads(pickle.dumps(port))
    want = ref.compute()
    for got in (port.compute(), clone.compute()):
        if kind == "FrechetInceptionDistance":
            _close(got, want, FID_RTOL)
        else:
            _close_scores(got, want)


def test_pickling_flushes_buffered_images():
    import pickle

    ref, port = _pair("FrechetInceptionDistance", extractor_batch=64)
    real, fake = _batches(18), _batches(19)
    _feed(ref, real, fake, False)
    _feed(port, real, fake, True)
    assert port._queue.pending
    clone = pickle.loads(pickle.dumps(port))
    assert not clone._queue.pending and not port._queue.pending
    for key in FID_STATES:
        assert _bits(clone.__dict__[key]) == _bits(getattr(ref, key)), key


def test_extractor_metrics_without_device_raise_when_cuda_is_absent(monkeypatch):
    import metrics_tpu_torch as mt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        for make in (lambda: mt.FrechetInceptionDistance(feature=_port_extractor, feature_dim=DIM),
                     lambda: mt.KernelInceptionDistance(feature=_port_extractor),
                     lambda: mt.InceptionScore(feature=_port_extractor),
                     lambda: mt.LearnedPerceptualImagePatchSimilarity(net=lambda a, b: a.sum())):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
