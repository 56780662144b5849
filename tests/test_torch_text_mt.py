"""The port's machine-translation metrics (TER, EED, BLEU, SacreBLEU, chrF) against the JAX package.

The corpus is seeded: sentences of 4-16 words from a small vocabulary with
capitals, digits, punctuation, ``&amp;``-style escapes and a few CJK
characters, hypotheses edited from one of one to three references.  Both
packages count on the host in the same Python, so every state is compared
bitwise (``tobytes``): host float64 sums cast to float32 once.  Scores that
go through the devices' ``log``/``exp`` (BLEU) are held to ``ULPS`` units in
the last place of float32 (the two libraries' ``exp``/``log`` are each within
one or two ulps of the true value, not the same ulp); every other score is
bitwise.
"""

import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.functional as jf
import metrics_tpu_torch as mt
import metrics_tpu_torch.functional as tf

ULPS = 8
_WORDS = ("the", "cat", "sat", "on", "a", "mat", "The", "dog", "ran", "far", "away", "3.5", "1,000", "U.S.",
          "e.g.", "Mr.", "&amp;", "isn't", "(it)", "well-known", "dr.", "jumps", "over", "lazy", "fox", "!",
          "?", "\"quoted\"", "100%", "猫", "は", "ここ")


def _sentence(rng, lo=4, hi=16):
    return " ".join(_WORDS[i] for i in rng.integers(0, len(_WORDS), size=rng.integers(lo, hi)))


def _edit(rng, ref):
    words = ref.split()
    out = []
    for w in words:
        u = rng.random()
        if u < 0.15:
            out.append(_WORDS[rng.integers(0, len(_WORDS))])
        elif u < 0.25:
            continue
        else:
            out.append(w)
    if len(out) > 3 and rng.random() < 0.3:  # a phrase moved (TER's shifts)
        i = int(rng.integers(0, len(out) - 2))
        phrase = out[i : i + 2]
        del out[i : i + 2]
        out[len(out):] = phrase
    return " ".join(out)


def _corpus(seed, n, multi=True):
    rng = np.random.default_rng(seed)
    preds, target = [], []
    for _ in range(n):
        refs = [_sentence(rng) for _ in range(int(rng.integers(1, 4)) if multi else 1)]
        preds.append(_edit(rng, refs[int(rng.integers(0, len(refs)))]))
        target.append(refs)
    return preds, target


def _batches(seed=0, sizes=(5, 1, 7)):
    preds, target = _corpus(seed, sum(sizes))
    out, at = [], 0
    for size in sizes:
        out.append((preds[at : at + size], target[at : at + size]))
        at += size
    return out


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(x):
    return np.asarray(_np(x), dtype=np.float32).tobytes()


def _assert_ulps(got, want, ulps=ULPS, what=""):
    got, want = np.asarray(_np(got), np.float32), np.asarray(_np(want), np.float32)
    assert got.shape == want.shape, what
    tol = ulps * np.float32(2.0**-24) * np.maximum(np.abs(want), np.float32(2.0**-126))
    assert np.all((np.abs(got - want) <= tol) | (got == want)), (what, got, want)


# (JAX/port functional, module class, constructor kwargs, the float states, scores bitwise)
CASES = {
    "ter": ("translation_edit_rate", "TranslationEditRate", {}, ("total_num_edits", "total_tgt_length"), True),
    "ter-normalized": ("translation_edit_rate", "TranslationEditRate",
                       {"normalize": True, "no_punctuation": True, "lowercase": False, "asian_support": True},
                       ("total_num_edits", "total_tgt_length"), True),
    "eed": ("extended_edit_distance", "ExtendedEditDistance", {}, ("score_sum", "score_count"), True),
    "eed-ja": ("extended_edit_distance", "ExtendedEditDistance", {"language": "ja", "alpha": 1.5},
               ("score_sum", "score_count"), True),
    "bleu": ("bleu_score", "BLEUScore", {}, ("preds_len", "target_len", "numerator", "denominator"), False),
    "bleu-smooth": ("bleu_score", "BLEUScore", {"n_gram": 2, "smooth": True, "weights": (0.3, 0.7)},
                    ("preds_len", "target_len", "numerator", "denominator"), False),
    "chrf++": ("chrf_score", "CHRFScore", {}, ("preds_char", "preds_word", "target_char", "target_word",
                                               "matching_char", "matching_word"), False),
    "chrf": ("chrf_score", "CHRFScore", {"n_word_order": 0, "beta": 3.0, "lowercase": True, "whitespace": True},
             ("preds_char", "preds_word", "target_char", "target_word", "matching_char", "matching_word"), False),
}
SACRE_TOKENIZERS = ("none", "13a", "zh", "intl", "char")
for _tok in SACRE_TOKENIZERS:
    CASES[f"sacrebleu-{_tok}"] = ("sacre_bleu_score", "SacreBLEUScore", {"tokenize": _tok, "lowercase": _tok == "13a"},
                                  ("preds_len", "target_len", "numerator", "denominator"), False)


def _check_score(got, want, exact, what):
    if exact:
        assert _bits(got) == _bits(want), (what, _np(got), _np(want))
    else:
        _assert_ulps(got, want, what=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_functionals_match_the_jax_package(case):
    fn, _, kwargs, _, exact = CASES[case]
    for preds, target in _batches(1) + [("a lone hypothesis", [["a lone reference", "another one"]])]:
        got = getattr(tf, fn)(preds, target, **kwargs)
        want = getattr(jf, fn)(preds, target, **kwargs)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        _check_score(got, want, exact, (case, preds))


@pytest.mark.parametrize("fn", ["translation_edit_rate", "extended_edit_distance", "chrf_score"])
def test_sentence_level_scores_are_bitwise(fn):
    preds, target = _corpus(2, 9)
    got_score, got_sent = getattr(tf, fn)(preds, target, return_sentence_level_score=True)
    want_score, want_sent = getattr(jf, fn)(preds, target, return_sentence_level_score=True)
    assert _bits(got_sent) == _bits(want_sent)
    _check_score(got_score, want_score, fn != "chrf_score", fn)


@pytest.mark.parametrize("case", sorted(CASES))
def test_modules_stream_like_the_jax_package(case):
    _, cls, kwargs, states, exact = CASES[case]
    ref, port = getattr(jm, cls)(**kwargs), getattr(mt, cls)(device="cpu", **kwargs)
    ref_fwd, port_fwd = getattr(jm, cls)(**kwargs), getattr(mt, cls)(device="cpu", **kwargs)
    for preds, target in _batches(3):
        ref.update(preds, target)
        port.update(preds, target)
        _check_score(port_fwd(preds, target), ref_fwd(preds, target), exact, (case, "forward"))
    _check_score(port.compute(), ref.compute(), exact, (case, "compute"))
    _check_score(port_fwd.compute(), ref_fwd.compute(), exact, (case, "forward compute"))
    for name in states:
        got, want = getattr(port, name), np.asarray(getattr(ref, name))
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape, name
        assert _bits(got) == want.tobytes(), (case, name)
        assert _bits(getattr(port_fwd, name)) == np.asarray(getattr(ref_fwd, name)).tobytes(), (case, name)
    port.reset()
    ref.reset()
    preds, target = _batches(4)[0]
    port.update(preds, target)
    ref.update(preds, target)
    _check_score(port.compute(), ref.compute(), exact, (case, "after reset"))


@pytest.mark.parametrize("cls,state", [("TranslationEditRate", "sentence_ter"), ("ExtendedEditDistance", "sentence_eed"),
                                       ("CHRFScore", "sentence_chrf_score")])
def test_sentence_cat_states_stream_and_load_across(cls, state):
    ref = getattr(jm, cls)(return_sentence_level_score=True)
    port = getattr(mt, cls)(return_sentence_level_score=True, device="cpu")
    batches = _batches(5)
    for preds, target in batches[:2]:
        ref.update(preds, target)
        port.update(preds, target)
    assert port._host_buffers_dirty  # the sums still wait; the cat state took its rows without a flush
    (g_score, g_sent), (w_score, w_sent) = port.compute(), ref.compute()
    assert _bits(g_sent) == _bits(w_sent)
    _check_score(g_score, w_score, cls != "CHRFScore", cls)
    # a JAX checkpoint continues in the port with the same result
    loaded = getattr(mt, cls)(return_sentence_level_score=True, device="cpu")
    mt.load_jax_state(loaded, ref.state_pytree())
    for m in (loaded, ref):
        m.update(*batches[2])
    (g_score, g_sent), (w_score, w_sent) = loaded.compute(), ref.compute()
    assert _bits(g_sent) == _bits(w_sent)
    assert sum(len(v) for v in getattr(loaded, state)) == sum(len(v) for v in getattr(ref, state))
    _check_score(g_score, w_score, cls != "CHRFScore", cls)


@pytest.mark.parametrize("case", ["ter", "eed", "bleu", "chrf++", "sacrebleu-13a"])
def test_a_jax_checkpoint_continues_in_the_port(case):
    _, cls, kwargs, states, exact = CASES[case]
    ref = getattr(jm, cls)(**kwargs)
    batches = _batches(6)
    ref.update(*batches[0])
    port = getattr(mt, cls)(device="cpu", **kwargs)
    mt.load_jax_state(port, ref.state_pytree())
    for m in (port, ref):
        m.update(*batches[1])
    for name in states:
        assert _bits(getattr(port, name)) == np.asarray(getattr(ref, name)).tobytes(), (case, name)
    _check_score(port.compute(), ref.compute(), exact, case)


def test_an_update_issues_no_tensor_operation():
    metrics = [mt.BLEUScore(device="cpu"), mt.SacreBLEUScore(device="cpu"), mt.CHRFScore(device="cpu"),
               mt.TranslationEditRate(device="cpu"), mt.ExtendedEditDistance(device="cpu")]
    preds, target = _batches(7)[0]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for m in metrics:
            m.update(preds, target)
            m.update(preds, target)
    assert [e.name for e in prof.events() if e.name.startswith("aten::")] == []


def test_argument_checks_raise_as_in_the_jax_package():
    for kwargs in ({"n_char_order": 0}, {"n_word_order": -1}, {"beta": -1.0}):
        with pytest.raises(ValueError):
            mt.CHRFScore(device="cpu", **kwargs)
        with pytest.raises(ValueError):
            tf.chrf_score(["a"], [["a"]], **kwargs)
    with pytest.raises(ValueError):
        mt.ExtendedEditDistance(language="de", device="cpu")
    with pytest.raises(ValueError):
        tf.sacre_bleu_score(["a"], [["a"]], tokenize="moses")
    with pytest.raises(ValueError):
        tf.bleu_score(["a", "b"], [["a"]])
    with pytest.raises(ValueError):
        tf.bleu_score(["a"], [["a"]], weights=(1.0,), n_gram=2)


@pytest.mark.parametrize("params", [(2.0, 0.3, 0.2, 1.0), (0.5, 1.3, 0.05, 0.35)], ids=["defaults", "others"])
def test_the_native_eed_grid_is_the_python_grid_bitwise(params):
    """The host library's grid against the port's Python grid (its fallback) and the JAX package's,
    on random strings of blanks, letters and non-ASCII characters, empty ones included."""
    from metrics_tpu.functional.text.eed import _eed_function as jax_grid
    from metrics_tpu_torch._native import eed_batch, native_available
    from metrics_tpu_torch.functional.text.eed import _eed_function

    assert native_available()
    rng = np.random.default_rng(8)
    chars = list("ab c.") + ["é", "猫", "\U0001F600"]
    hyps = ["".join(rng.choice(chars, size=rng.integers(0, 40))) for _ in range(400)] + ["", " "]
    refs = ["".join(rng.choice(chars, size=rng.integers(0, 40))) for _ in range(400)] + [" ", ""]
    got = eed_batch(hyps, refs, *params)
    assert got.dtype == np.float64 and got.shape == (len(hyps),)
    want = [_eed_function(h, r, *params) for h, r in zip(hyps, refs)]
    assert got.tolist() == want == [jax_grid(h, r, *params) for h, r in zip(hyps, refs)]


def test_eed_without_the_library_takes_its_python_grid(monkeypatch):
    import metrics_tpu_torch._native as native

    preds, target = _corpus(9, 6)
    want = jf.extended_edit_distance(preds, target, return_sentence_level_score=True)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    got = tf.extended_edit_distance(preds, target, return_sentence_level_score=True)
    assert _bits(got[0]) == _bits(want[0]) and _bits(got[1]) == _bits(want[1])
