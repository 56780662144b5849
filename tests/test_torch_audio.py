"""The port's audio metrics (SNR, SI-SNR, SDR, SI-SDR, PIT, PESQ, STOI) against the JAX package.

Signals are seeded: a target of a few sines and noise, and a prediction that
is the target scaled, delayed by a few samples, filtered and noisier, so SDR's
distortion filter and the permutation search both have work.  The scores go
through float32 sums over time, ``log10`` and (SDR) rFFTs and a float32
solve, where the libraries round differently: SNR and SI-SDR are held to
``DB_ATOL`` dB, SDR to ``SDR_ATOL`` dB (the normal equations amplify the
correlations' last bits).  The permutations are compared exactly, as are the
int32 counts; the float32 sums to the scores' tolerance.
"""

import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.functional as jf
import metrics_tpu_torch as mt
import metrics_tpu_torch.functional as tf

DB_ATOL = 2e-4
SDR_ATOL = 2e-3


def _signals(seed, shape, length=400):
    rng = np.random.default_rng(seed)
    t = np.arange(length) / 8000.0
    n = int(np.prod(shape))
    freqs = rng.uniform(80, 900, size=(n, 3))
    target = np.sin(2 * np.pi * freqs[:, :, None] * t).sum(1) + 0.3 * rng.normal(size=(n, length))
    delayed = np.roll(target, rng.integers(0, 4), axis=-1)
    smooth = 0.6 * delayed + 0.4 * np.roll(delayed, 1, axis=-1)
    preds = rng.uniform(0.5, 2.0, size=(n, 1)) * smooth + 0.4 * rng.normal(size=(n, length))
    return (preds.reshape(*shape, length).astype(np.float32), target.reshape(*shape, length).astype(np.float32))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=str(what))


FUNCTIONALS = {
    "snr": ("signal_noise_ratio", {}, DB_ATOL),
    "snr-zero-mean": ("signal_noise_ratio", {"zero_mean": True}, DB_ATOL),
    "si-snr": ("scale_invariant_signal_noise_ratio", {}, DB_ATOL),
    "si-sdr": ("scale_invariant_signal_distortion_ratio", {}, DB_ATOL),
    "si-sdr-zero-mean": ("scale_invariant_signal_distortion_ratio", {"zero_mean": True}, DB_ATOL),
    "sdr": ("signal_distortion_ratio", {"filter_length": 64}, SDR_ATOL),
    "sdr-zero-mean-load-diag": ("signal_distortion_ratio", {"filter_length": 32, "zero_mean": True, "load_diag": 1e-3,
                                                            "use_cg_iter": 10}, SDR_ATOL),
    "sdr-filter-past-the-signal": ("signal_distortion_ratio", {"filter_length": 512}, SDR_ATOL),
}


@pytest.mark.parametrize("case", sorted(FUNCTIONALS))
def test_functionals_match_the_jax_package(case):
    fn, kwargs, atol = FUNCTIONALS[case]
    length = 300 if case == "sdr-filter-past-the-signal" else 400
    preds, target = _signals(0, (3, 2), length)
    got = getattr(tf, fn)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    assert got.dtype == torch.float32 and got.shape == (3, 2)
    _close(got, getattr(jf, fn)(preds, target, **kwargs), atol, case)
    single = getattr(tf, fn)(torch.from_numpy(preds[0, 0]), torch.from_numpy(target[0, 0]), **kwargs)
    _close(single, getattr(jf, fn)(preds[0, 0], target[0, 0], **kwargs), atol, case)


def test_sdr_helpers_match_the_jax_package():
    from metrics_tpu.functional.audio.sdr import _compute_autocorr_crosscorr as jax_corr
    from metrics_tpu.functional.audio.sdr import _symmetric_toeplitz as jax_toeplitz
    from metrics_tpu_torch.functional.audio.sdr import _compute_autocorr_crosscorr, _symmetric_toeplitz

    vec = (np.arange(24, dtype=np.float32).reshape(2, 12) / 8)
    assert _symmetric_toeplitz(torch.from_numpy(vec)).numpy().tobytes() == np.asarray(jax_toeplitz(vec)).tobytes()
    preds, target = _signals(1, (2,), 100)
    r0, b = _compute_autocorr_crosscorr(torch.from_numpy(target), torch.from_numpy(preds), 20)
    jr0, jb = jax_corr(target, preds, 20)
    _close(r0, jr0, 1e-3, "autocorr")
    _close(b, jb, 1e-3, "crosscorr")


MODULES = {
    "SignalNoiseRatio": ({"zero_mean": True}, "sum_snr", DB_ATOL),
    "ScaleInvariantSignalNoiseRatio": ({}, "sum_si_snr", DB_ATOL),
    "SignalDistortionRatio": ({"filter_length": 48}, "sum_sdr", SDR_ATOL),
    "ScaleInvariantSignalDistortionRatio": ({}, "sum_si_sdr", DB_ATOL),
}


@pytest.mark.parametrize("cls", sorted(MODULES))
def test_modules_stream_like_the_jax_package(cls):
    kwargs, sum_name, atol = MODULES[cls]
    ref, port = getattr(jm, cls)(**kwargs), getattr(mt, cls)(device="cpu", **kwargs)
    ref_fwd, port_fwd = getattr(jm, cls)(**kwargs), getattr(mt, cls)(device="cpu", **kwargs)
    for seed, shape in ((1, (4,)), (2, (1,)), (3, (2, 3))):
        preds, target = _signals(seed, shape)
        ref.update(preds, target)
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        _close(port_fwd(torch.from_numpy(preds), torch.from_numpy(target)), ref_fwd(preds, target), atol, "forward")
    _close(port.compute(), ref.compute(), atol, cls)
    _close(port_fwd.compute(), ref_fwd.compute(), atol, cls)
    assert port.total.dtype == torch.int32 and int(port.total) == int(ref.total) == 11
    _close(getattr(port, sum_name), np.asarray(getattr(ref, sum_name)), 11 * atol, sum_name)
    loaded = getattr(mt, cls)(device="cpu", **kwargs)
    mt.load_jax_state(loaded, ref.state_pytree())
    assert int(loaded.total) == 11 and loaded.total.dtype == torch.int32
    assert _np(getattr(loaded, sum_name)).tobytes() == np.asarray(getattr(ref, sum_name)).tobytes()


def _mixture(seed, batch, spk, length=200):
    """Predictions that are a permutation of noisy targets (so the best permutation is clear)."""
    rng = np.random.default_rng(seed)
    target = rng.normal(size=(batch, spk, length)).astype(np.float32)
    perm = np.stack([rng.permutation(spk) for _ in range(batch)])
    preds = np.take_along_axis(target, perm[:, :, None], axis=1) + 0.3 * rng.normal(size=(batch, spk, length))
    return preds.astype(np.float32), target


@pytest.mark.parametrize("spk,eval_func", [(2, "max"), (3, "max"), (3, "min"), (7, "max"), (7, "min")])
def test_pit_matches_the_jax_package(spk, eval_func):
    preds, target = _mixture(spk, 4, spk)
    metric_t, metric_j = tf.scale_invariant_signal_distortion_ratio, jf.scale_invariant_signal_distortion_ratio
    if eval_func == "min":  # a lower-is-better metric: the negated SI-SDR
        metric_t = lambda p, t: -tf.scale_invariant_signal_distortion_ratio(p, t)  # noqa: E731
        metric_j = lambda p, t: -jf.scale_invariant_signal_distortion_ratio(p, t)  # noqa: E731
    best, perm = tf.permutation_invariant_training(torch.from_numpy(preds), torch.from_numpy(target), metric_t, eval_func)
    jbest, jperm = jf.permutation_invariant_training(preds, target, metric_j, eval_func)
    assert perm.dtype == torch.int32 and perm.numpy().tobytes() == np.asarray(jperm).tobytes()
    _close(best, jbest, DB_ATOL, (spk, eval_func))
    permuted = tf.pit_permutate(torch.from_numpy(preds), perm)
    assert permuted.numpy().tobytes() == np.asarray(jf.pit_permutate(preds, jperm)).tobytes()
    # the permuted predictions line up with their targets: each pair scores the best metric
    aligned = metric_t(permuted, torch.from_numpy(target)).mean(-1)
    _close(aligned, best, DB_ATOL, "aligned")


def test_pit_takes_the_lap_route_above_six_speakers(monkeypatch):
    import metrics_tpu_torch.functional.audio.pit as pit

    calls = []
    real = pit._pit_lap
    monkeypatch.setattr(pit, "_pit_lap", lambda *a: calls.append(1) or real(*a))
    preds, target = _mixture(11, 2, 7)
    pit.permutation_invariant_training(torch.from_numpy(preds), torch.from_numpy(target), tf.signal_noise_ratio)
    assert calls == [1]
    preds, target = _mixture(12, 2, 6)
    pit.permutation_invariant_training(torch.from_numpy(preds), torch.from_numpy(target), tf.signal_noise_ratio)
    assert calls == [1]


def test_pit_module_streams_like_the_jax_package():
    ref = jm.PermutationInvariantTraining(jf.signal_noise_ratio, "max", zero_mean=True)
    port = mt.PermutationInvariantTraining(tf.signal_noise_ratio, "max", zero_mean=True, device="cpu")
    for seed, (batch, spk) in enumerate(((3, 2), (1, 3), (2, 3))):
        preds, target = _mixture(20 + seed, batch, spk)
        ref.update(preds, target)
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
    _close(port.compute(), ref.compute(), DB_ATOL, "pit module")
    assert int(port.total) == int(ref.total) == 6 and port.total.dtype == torch.int32


def test_pit_input_checks():
    x = torch.zeros(2, 2, 10)
    with pytest.raises(ValueError):
        tf.permutation_invariant_training(x, x, tf.signal_noise_ratio, "mean")
    with pytest.raises(ValueError):
        tf.permutation_invariant_training(x, torch.zeros(2, 3, 10), tf.signal_noise_ratio)
    with pytest.raises(ValueError):
        tf.permutation_invariant_training(torch.zeros(10), torch.zeros(10), tf.signal_noise_ratio)
    with pytest.raises(ValueError):
        mt.PermutationInvariantTraining(tf.signal_noise_ratio, "median", device="cpu")


def _raises_like(port_call, jax_call):
    with pytest.raises(ModuleNotFoundError) as got:
        port_call()
    with pytest.raises(ModuleNotFoundError) as want:
        jax_call()
    assert str(got.value) == str(want.value)


def test_pesq_and_stoi_gates_raise_as_the_jax_ones_do():
    from metrics_tpu_torch.utils.imports import _PESQ_AVAILABLE, _PYSTOI_AVAILABLE

    if _PESQ_AVAILABLE or _PYSTOI_AVAILABLE:
        pytest.skip("pesq or pystoi is installed: the gates are open")
    x = np.zeros((2, 8000), np.float32)
    _raises_like(lambda: tf.perceptual_evaluation_speech_quality(torch.from_numpy(x), torch.from_numpy(x), 8000, "nb"),
                 lambda: jf.perceptual_evaluation_speech_quality(x, x, 8000, "nb"))
    _raises_like(lambda: tf.short_time_objective_intelligibility(torch.from_numpy(x), torch.from_numpy(x), 8000),
                 lambda: jf.short_time_objective_intelligibility(x, x, 8000))
    _raises_like(lambda: mt.PerceptualEvaluationSpeechQuality(8000, "nb", device="cpu"),
                 lambda: jm.PerceptualEvaluationSpeechQuality(8000, "nb"))
    _raises_like(lambda: mt.ShortTimeObjectiveIntelligibility(8000, device="cpu"),
                 lambda: jm.ShortTimeObjectiveIntelligibility(8000))


def test_an_open_gate_runs_the_host_loop_and_keeps_the_device(monkeypatch):
    """With the backends present (stand-ins here), each signal is scored on the host
    and the scores come back as float32 on the inputs' device."""
    import sys
    import types

    import metrics_tpu_torch.audio.pesq as pesq_mod
    import metrics_tpu_torch.functional.audio.pesq as fpesq
    import metrics_tpu_torch.functional.audio.stoi as fstoi

    fake_pesq = types.ModuleType("pesq")
    fake_pesq.pesq = lambda fs, ref, deg, mode: float(np.abs(ref - deg).mean() + fs / 8000)
    fake_pystoi = types.ModuleType("pystoi")
    fake_pystoi.stoi = lambda ref, deg, fs, extended: float(np.abs(ref).mean() + extended)
    monkeypatch.setitem(sys.modules, "pesq", fake_pesq)
    monkeypatch.setitem(sys.modules, "pystoi", fake_pystoi)
    for module in (fpesq, pesq_mod):
        monkeypatch.setattr(module, "_PESQ_AVAILABLE", True)
    monkeypatch.setattr(fstoi, "_PYSTOI_AVAILABLE", True)
    preds, target = _signals(5, (2, 3))
    got = tf.perceptual_evaluation_speech_quality(torch.from_numpy(preds), torch.from_numpy(target), 16000, "wb")
    want = np.abs(target - preds).mean(-1) + 2.0
    assert got.dtype == torch.float32 and got.shape == (2, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    got = tf.short_time_objective_intelligibility(torch.from_numpy(preds), torch.from_numpy(target), 8000, True)
    np.testing.assert_allclose(got.numpy(), np.abs(target).mean(-1) + 1.0, rtol=1e-6)
    metric = mt.PerceptualEvaluationSpeechQuality(8000, "nb", device="cpu")
    metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert metric.sum_pesq.device.type == "cpu" and int(metric.total) == 6
    with pytest.raises(ValueError):
        mt.PerceptualEvaluationSpeechQuality(44100, "nb", device="cpu")
