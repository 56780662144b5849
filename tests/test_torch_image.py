"""The port's image metrics (PSNR, SSIM, MS-SSIM, UQI, ERGAS, SAM, D-lambda, gradients) against the
JAX package's, functionals and modules, on the same seeded inputs, on the CPU.

Tolerances, and why:

* PSNR, ERGAS and SAM have no convolution: elementwise float32 work and sums
  whose order differs between XLA and PyTorch by a few ulps of the result,
  so they hold to ``rtol = 1e-6`` (gradients: bitwise, one subtraction);
  SAM's per-pixel map to ``SAM_MAP_ATOL`` (arccos near 1, see there).
* SSIM, MS-SSIM, UQI and D-lambda sum 121 (or 1331) products per output in
  their depthwise convolution, and XLA's CPU convolution and oneDNN's add
  them in different orders.  A window sum carries a few float32 ulps of the
  image's magnitude; the variance terms cancel (``E[x^2] - mu^2``), so a
  score's error scales with ``ulp(1) / variance``.  Reduced scores hold to
  ``atol = 1e-5``; per-pixel maps, where a flat window's variance is small,
  to ``atol = 1e-3`` (MS-SSIM's product of five powers to ``1e-5``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import metrics_tpu as jm
import metrics_tpu.functional.image as jf
import metrics_tpu_torch as mt
import metrics_tpu_torch.functional.image as tf

ELEMENTWISE_RTOL = 1e-6
CONV_ATOL = 1e-5
MAP_ATOL = 1e-3
# a per-pixel spectral angle is arccos of a float32 cosine that carries an ulp or two (1.2e-7) of
# rounding; arccos' slope 1 / sqrt(1 - x^2) reaches about 1,000 at the smallest angles drawn here
SAM_MAP_ATOL = 2e-4


def _images(seed, shape=(3, 3, 48, 40), noise=0.1):
    rng = np.random.default_rng(seed)
    preds = rng.random(shape).astype(np.float32)
    target = np.clip(0.8 * preds + noise * rng.random(shape).astype(np.float32), 0, 1).astype(np.float32)
    return preds, target


def _close(got, want, rtol=0.0, atol=0.0):
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
        return
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _both(name, args, kwargs, rtol=0.0, atol=0.0):
    # one jit of the whole reference compiles faster than its operations one by one
    reference = jax.jit(lambda *xs: getattr(jf, name)(*xs, **kwargs))
    want = reference(*(jnp.asarray(a) for a in args))
    got = getattr(tf, name)(*(torch.from_numpy(a) for a in args), **kwargs)
    _close(got, want, rtol, atol)


@pytest.mark.parametrize("kwargs", [{}, dict(data_range=1.0, base=2.0), dict(data_range=1.0, dim=(1, 2, 3), reduction="none"),
                                    dict(data_range=1.0, dim=1, reduction="sum")], ids=["global", "base2", "per_image", "sum"])
def test_psnr_functional(kwargs):
    _both("peak_signal_noise_ratio", _images(0), kwargs, rtol=ELEMENTWISE_RTOL)


@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_ergas_and_sam_functionals(reduction):
    _both("error_relative_global_dimensionless_synthesis", _images(1), dict(ratio=4, reduction=reduction), rtol=ELEMENTWISE_RTOL)
    if reduction == "none":  # per pixel, arccos' slope near 1 magnifies an ulp of the cosine
        _both("spectral_angle_mapper", _images(2), dict(reduction=reduction), atol=SAM_MAP_ATOL)
    else:
        _both("spectral_angle_mapper", _images(2), dict(reduction=reduction), rtol=ELEMENTWISE_RTOL)


def test_image_gradients_bitwise():
    img = np.random.default_rng(3).random((2, 3, 9, 7)).astype(np.float32)
    _close(tf.image_gradients(torch.from_numpy(img)), jf.image_gradients(jnp.asarray(img)))


@pytest.mark.parametrize("kwargs", [
    {}, dict(data_range=1.0, reduction="none"), dict(gaussian_kernel=False, kernel_size=7, data_range=1.0),
    dict(sigma=(1.0, 2.0), k1=0.02, reduction="sum"),
], ids=["default", "per_image", "uniform_window", "anisotropic"])
def test_ssim_functional(kwargs):
    _both("structural_similarity_index_measure", _images(4), kwargs, atol=CONV_ATOL)


def test_ssim_full_image_contrast_sensitivity_and_3d():
    preds, target = _images(5)
    _both("structural_similarity_index_measure", (preds, target), dict(return_full_image=True, reduction="none"), atol=MAP_ATOL)
    _both("structural_similarity_index_measure", (preds, target), dict(return_contrast_sensitivity=True), atol=CONV_ATOL)
    vol = _images(6, shape=(2, 1, 12, 16, 14))
    _both("structural_similarity_index_measure", vol, dict(sigma=0.8, data_range=1.0), atol=CONV_ATOL)


THREE_SCALES = (0.2, 0.3, 0.5)  # three scales keep the images small: height // 4 must exceed the window


@pytest.mark.parametrize("normalize", [None, "relu", "simple"])
def test_multiscale_ssim_functional(normalize):
    if normalize is None:  # the five default scales need 176 pixels a side
        _both("multiscale_structural_similarity_index_measure", _images(7, shape=(1, 1, 176, 176)),
              dict(data_range=1.0), atol=CONV_ATOL)
    _both("multiscale_structural_similarity_index_measure", _images(7, shape=(2, 2, 48, 48)),
          dict(data_range=1.0, normalize=normalize, betas=THREE_SCALES), atol=CONV_ATOL)


@pytest.mark.parametrize("reduction", ["elementwise_mean", "none"])
def test_uqi_functional(reduction):
    _both("universal_image_quality_index", _images(8), dict(reduction=reduction),
          atol=CONV_ATOL if reduction == "elementwise_mean" else MAP_ATOL)


@pytest.mark.parametrize("p", [1, 2])
def test_d_lambda_functional(p):
    _both("spectral_distortion_index", _images(9, shape=(3, 4, 24, 24), noise=0.4), dict(p=p), atol=CONV_ATOL)


def _stream(name, ctor_kwargs, batches, rtol=0.0, atol=0.0):
    ref = getattr(jm, name)(**ctor_kwargs)
    port = getattr(mt, name)(device="cpu", **ctor_kwargs)
    for preds, target in batches:
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
    _close(port.compute(), ref.compute(), rtol, atol)
    return port


@pytest.mark.parametrize("name,kwargs,rtol,atol", [
    ("PeakSignalNoiseRatio", {}, ELEMENTWISE_RTOL, 0.0),
    ("PeakSignalNoiseRatio", dict(data_range=1.0, dim=(1, 2, 3), reduction="none"), ELEMENTWISE_RTOL, 0.0),
    ("ErrorRelativeGlobalDimensionlessSynthesis", {}, ELEMENTWISE_RTOL, 0.0),
    ("ErrorRelativeGlobalDimensionlessSynthesis", dict(reduction="none"), ELEMENTWISE_RTOL, 0.0),
    ("SpectralAngleMapper", {}, ELEMENTWISE_RTOL, 0.0),
    ("StructuralSimilarityIndexMeasure", dict(data_range=1.0), 0.0, CONV_ATOL),
    ("StructuralSimilarityIndexMeasure", dict(data_range=1.0, reduction="sum"), 0.0, 3 * CONV_ATOL),
    ("StructuralSimilarityIndexMeasure", dict(reduction="none"), 0.0, CONV_ATOL),
    ("UniversalImageQualityIndex", {}, 0.0, CONV_ATOL),
    ("SpectralDistortionIndex", {}, 0.0, CONV_ATOL),
], ids=["psnr", "psnr_dim", "ergas", "ergas_none", "sam", "ssim", "ssim_sum", "ssim_none", "uqi", "d_lambda"])
def test_modules_stream_like_the_jax_package(name, kwargs, rtol, atol):
    batches = [_images(20 + i, shape=(3, 3, 40, 36)) for i in range(3)]
    port = _stream(name, kwargs, batches, rtol, atol)
    state = port.state_pytree()
    if "total" in state and isinstance(state["total"], torch.Tensor) and state["total"].ndim == 0:
        assert state["total"].dtype == torch.int32


@pytest.mark.parametrize("reduction", ["elementwise_mean", "none"])
def test_multiscale_ssim_module(reduction):
    batches = [_images(30 + i, shape=(2, 2, 48, 48)) for i in range(2)]
    _stream("MultiScaleStructuralSimilarityIndexMeasure",
            dict(data_range=1.0, reduction=reduction, normalize="relu", betas=THREE_SCALES), batches, atol=CONV_ATOL)


def test_d_lambda_state_widens_and_loads_from_jax():
    batches = [_images(40 + i, shape=(2, 3, 24, 24), noise=0.4) for i in range(2)]
    ref = jm.SpectralDistortionIndex()
    ref.update(*(jnp.asarray(a) for a in batches[0]))
    port = mt.SpectralDistortionIndex(device="cpu")
    mt.load_jax_state(port, ref.state_pytree())
    assert tuple(port.m1_sum.shape) == (3, 3)
    ref.update(*(jnp.asarray(a) for a in batches[1]))
    port.update(*(torch.from_numpy(a) for a in batches[1]))
    _close(port.compute(), ref.compute(), atol=CONV_ATOL)


def test_errors_match_the_jax_package():
    preds, target = (torch.from_numpy(a) for a in _images(50))
    for fn, args, err in (
        (tf.structural_similarity_index_measure, (preds, target.to(torch.int32)), TypeError),
        (tf.structural_similarity_index_measure, (preds[0], target[0]), ValueError),
        (tf.universal_image_quality_index, (preds, target[:1]), RuntimeError),
        (tf.spectral_angle_mapper, (preds[:, :1], target[:, :1]), ValueError),
        (tf.image_gradients, (preds[0],), RuntimeError),
    ):
        with pytest.raises(err):
            fn(*args)
    with pytest.raises(ValueError, match="data_range"):
        tf.peak_signal_noise_ratio(preds, target, dim=1)
    with pytest.raises(ValueError, match="positive integer"):
        mt.SpectralDistortionIndex(p=0, device="cpu")
    with pytest.raises(ValueError, match="betas"):
        mt.MultiScaleStructuralSimilarityIndexMeasure(betas=[0.5], device="cpu")
    with pytest.raises(ValueError, match="Reduction"):
        mt.UniversalImageQualityIndex(reduction="max", device="cpu")


def test_convolutions_ignore_the_process_wide_tf32_flag():
    preds, target = (torch.from_numpy(a) for a in _images(51))
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32
    try:
        cudnn.allow_tf32 = True
        on = tf.structural_similarity_index_measure(preds, target)
        assert cudnn.allow_tf32 is True  # the switch is local to the convolution
        cudnn.allow_tf32 = False
        off = tf.structural_similarity_index_measure(preds, target)
    finally:
        cudnn.allow_tf32 = before
    assert torch.equal(on, off)
