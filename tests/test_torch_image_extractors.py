"""The port's Inception-v3 extractor against the JAX package's, on weights carried across.

The JAX package's variables trees are laid out by ``jax.eval_shape`` of its
own modules' ``init`` and filled from a seeded numpy generator (non-trivial
batch-norm statistics included), then carried into the port by
``inception_state_dict_from_flax`` / ``lpips_state_dict_from_flax``.

Tolerances: Inception taps ``rtol=1e-4, atol=1e-5`` (float32 through ~95
convolutions summed in other orders); the resizes ``atol=1e-5`` on [0, 255]
floats; the optimized (BN-folded, head-fused) path against the canonical one
``5e-4``, as ``tests/image/test_inception_fast_path.py`` holds the JAX
package's.  The converters (Inception's and the LPIPS nets') are the exact
inverse of ``tools/convert_weights.py``: the round trip is bitwise.
"""

import numpy as np
import pytest
import torch

TAP_TOL = dict(rtol=1e-4, atol=1e-5)
SIDE = 75  # the smallest input the trunk takes: the model-level comparisons run there


def _fill(shapes, seed: int):
    """A variables tree of the given ShapeDtypeStructs, seeded: kernels normal over sqrt(fan-in),
    batch-norm scales and variances in [0.5, 1.5], biases and means small."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1]
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    def walk(tree, path=()):
        return {k: walk(v, path + (k,)) if isinstance(v, dict) else leaf(path + (k,), v) for k, v in tree.items()}

    return walk(shapes)


def _plain(tree):
    return {k: _plain(v) if hasattr(v, "items") else v for k, v in tree.items()}


@pytest.fixture(scope="module")
def inception_variables():
    import jax
    import jax.numpy as jnp

    from metrics_tpu.image.backbones.inception import FlaxInceptionV3

    shapes = jax.eval_shape(FlaxInceptionV3().init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 299, 299, 3), jnp.float32))
    return _fill(_plain(shapes), seed=0)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(1)
    return rng.integers(0, 256, size=(3, 3, 37, 45), dtype=np.uint8)


@pytest.fixture(scope="module")
def model_inputs():
    rng = np.random.default_rng(2)
    return rng.uniform(-1, 1, size=(2, 3, SIDE, SIDE)).astype(np.float32)


@pytest.mark.parametrize("fid_variant", [True, False], ids=["fid", "textbook"])
def test_every_tap_matches_the_jax_module(inception_variables, model_inputs, fid_variant):
    import jax
    import jax.numpy as jnp

    from metrics_tpu.image.backbones.inception import FlaxInceptionV3
    from metrics_tpu_torch.image.backbones import InceptionV3, inception_state_dict_from_flax
    from metrics_tpu_torch.image.backbones.inception import load_weights

    want = jax.jit(FlaxInceptionV3(fid_variant=fid_variant).apply)(
        inception_variables, jnp.asarray(model_inputs.transpose(0, 2, 3, 1)))
    model = InceptionV3(fid_variant=fid_variant)
    load_weights(model, inception_state_dict_from_flax(inception_variables))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(model_inputs))
    assert set(got) == set(want) == {"64", "192", "768", "2048", "logits_unbiased"}
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), err_msg=key, **TAP_TOL)
    with torch.no_grad():  # a run up to a tap stops there and gives the same value
        early = model(torch.from_numpy(model_inputs), "192")
    assert set(early) == {"64", "192"} and torch.equal(early["192"], got["192"])


@pytest.mark.parametrize("fid_variant", [True, False], ids=["fid", "textbook"])
def test_the_extractor_matches_the_jax_extractor_at_the_64_tap(inception_variables, images, fid_variant):
    from metrics_tpu.image.backbones.inception import InceptionFeatureExtractor as JaxExtractor
    from metrics_tpu_torch.image.backbones import InceptionFeatureExtractor

    want = np.asarray(JaxExtractor("64", variables=inception_variables, fid_variant=fid_variant)(images))
    port = InceptionFeatureExtractor("64", variables=inception_variables, fid_variant=fid_variant, device="cpu")
    got = port(torch.from_numpy(images))
    assert got.dtype == torch.float32 and got.shape == (3, 64)
    np.testing.assert_allclose(got.numpy(), want, **TAP_TOL)
    nhwc = port(torch.from_numpy(images.transpose(0, 2, 3, 1).copy()))  # the NHWC rule
    assert torch.equal(nhwc, got)


def test_the_resizes_match_xla(images):
    import jax
    import jax.numpy as jnp

    from metrics_tpu.image.backbones.inception import tf1_resize_bilinear as jax_tf1
    from metrics_tpu_torch.image.backbones.inception import resize_bilinear, tf1_resize_bilinear

    x = images.astype(np.float32)
    nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    want = np.asarray(jax_tf1(nhwc, 299, 299)).transpose(0, 3, 1, 2)
    got = tf1_resize_bilinear(torch.from_numpy(x), 299, 299).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for out_h, out_w in ((299, 299), (20, 31)):  # up, and down (antialiased)
        want = np.asarray(jax.image.resize(nhwc, (3, out_h, out_w, 3), method="bilinear")).transpose(0, 3, 1, 2)
        got = resize_bilinear(torch.from_numpy(x), out_h, out_w).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * 255)


@pytest.mark.parametrize("fid_variant", [True, False], ids=["fid", "textbook"])
def test_the_optimized_path_matches_the_canonical_one(inception_variables, model_inputs, fid_variant):
    from metrics_tpu_torch.image.backbones import FoldedInceptionV3, InceptionV3, inception_state_dict_from_flax
    from metrics_tpu_torch.image.backbones.inception import load_weights

    model = InceptionV3(fid_variant=fid_variant)
    load_weights(model, inception_state_dict_from_flax(inception_variables))
    model.eval()
    x = torch.from_numpy(model_inputs)
    with torch.no_grad():
        want, got = model(x), FoldedInceptionV3(model)(x)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=5e-4, atol=5e-4, err_msg=key)


def test_the_fold_matches_the_jax_fold(inception_variables):
    import jax

    from metrics_tpu.image.backbones.inception import fold_inception_variables
    from metrics_tpu_torch.image.backbones import FoldedInceptionV3, InceptionV3, inception_state_dict_from_flax
    from metrics_tpu_torch.image.backbones.inception import load_weights

    fast = jax.jit(fold_inception_variables)(inception_variables)  # as the JAX extractor folds
    model = InceptionV3()
    load_weights(model, inception_state_dict_from_flax(inception_variables))
    folded = FoldedInceptionV3(model)
    assert len(folded.weights) == len(fast["convs"])
    for i, ((kernel, bias), weight, b) in enumerate(zip(fast["convs"], folded.weights, folded.biases)):
        np.testing.assert_allclose(weight.numpy(), np.asarray(kernel).transpose(3, 2, 0, 1), rtol=1e-6, atol=1e-7,
                                   err_msg=str(i))
        np.testing.assert_allclose(b.numpy(), np.asarray(bias), rtol=1e-6, atol=1e-7, err_msg=str(i))
    assert np.array_equal(folded.fc.numpy().T, np.asarray(fast["dense"]))


def test_the_converters_invert_tools_convert_weights(inception_variables):
    import jax
    import jax.numpy as jnp

    from metrics_tpu.image.lpip import _LpipsBackbone
    from metrics_tpu_torch.image.backbones import inception_state_dict_from_flax, lpips_state_dict_from_flax
    from tools import convert_weights as cw

    back = cw.convert_inception_v3(inception_state_dict_from_flax(inception_variables), inception_variables)
    assert cw.flatten_params(back).keys() == cw.flatten_params(inception_variables).keys()
    for key, value in cw.flatten_params(inception_variables).items():
        assert np.asarray(cw.flatten_params(back)[key]).tobytes() == value.tobytes(), key
    converters = {"vgg": cw.convert_lpips_vgg16, "alex": cw.convert_lpips_alexnet,
                  "squeeze": cw.convert_lpips_squeezenet}
    for net_type, convert in converters.items():
        shapes = jax.eval_shape(_LpipsBackbone(net_type).init, jax.random.PRNGKey(0),
                                jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32),
                                jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))
        params = _fill(_plain(shapes)["params"], seed=3)
        back = cw.flatten_params(convert(lpips_state_dict_from_flax(params, net_type)))
        assert back.keys() == cw.flatten_params(params).keys(), net_type
        for key, value in cw.flatten_params(params).items():
            assert back[key].tobytes() == value.tobytes(), (net_type, key)
    bad = {**inception_variables, "params": {**inception_variables["params"]}}
    bad["params"]["Dense_0"] = {"kernel": np.zeros((2048, 1000), np.float32)}
    with pytest.raises(ValueError, match="Shape mismatch"):
        inception_state_dict_from_flax(bad)


def test_one_converted_npz_serves_both_packages(inception_variables, images, tmp_path, monkeypatch):
    import warnings

    from metrics_tpu.image.backbones import weights as jax_weights
    from metrics_tpu_torch import FrechetInceptionDistance
    from metrics_tpu_torch.image.backbones import InceptionFeatureExtractor
    from metrics_tpu_torch.image.backbones import weights
    from tools.convert_weights import flatten_params

    np.savez(tmp_path / weights.INCEPTION_FILE, **flatten_params(inception_variables))
    monkeypatch.setenv("METRICS_TPU_WEIGHTS_DIR", str(tmp_path))
    assert weights.find_weight_file(weights.INCEPTION_FILE) == jax_weights.find_weight_file(jax_weights.INCEPTION_FILE)
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)  # weights found: no warning
        fid = FrechetInceptionDistance(feature=64, device="cpu")
    want = InceptionFeatureExtractor("64", variables=inception_variables, device="cpu")(torch.from_numpy(images))
    assert torch.equal(fid.extractor(torch.from_numpy(images)), want)
    assert not any(k.startswith("extractor") for k in fid.state_dict())  # weights are not states
    monkeypatch.setenv("METRICS_TPU_WEIGHTS_DIR", str(tmp_path / "none"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    with pytest.warns(UserWarning, match="No converted Inception weights"):
        FrechetInceptionDistance(feature=64, device="cpu")
