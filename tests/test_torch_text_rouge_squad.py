"""The port's ROUGE and SQuAD against the JAX package.

ROUGE runs on seeded multi-sentence summaries (sentences split by newlines
and by end punctuation, so ROUGE-Lsum's splitter has work) against one or two
references, under both ``accumulate`` rules, with and without the Porter
stemmer (skipped where ``nltk`` is missing).  SQuAD runs on seeded
questions with one to three answers, some unanswered and some with no
answer text.  Both packages score on the host in the same Python and sum in
float64, cast to float32 once, so every state and score is compared bitwise.
"""

import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.functional as jf
import metrics_tpu_torch as mt
import metrics_tpu_torch.functional as tf
from metrics_tpu_torch.utils.imports import _NLTK_AVAILABLE

_WORDS = ("the", "cats", "sat", "running", "on", "a", "mat", "dogs", "ran", "quickly", "Paris", "is", "capital",
          "of", "France", "won", "games", "2019", "players", "played", "fairly", "well", "it's", "U.S.")


def _summary(rng, sentences):
    out = []
    for _ in range(sentences):
        words = [_WORDS[i] for i in rng.integers(0, len(_WORDS), size=rng.integers(3, 12))]
        out.append(" ".join(words) + str(rng.choice([".", "!", "?"])))
    sep = "\n" if rng.random() < 0.5 else " "
    return sep.join(out)


def _rouge_corpus(seed, n):
    rng = np.random.default_rng(seed)
    preds, target = [], []
    for _ in range(n):
        preds.append(_summary(rng, int(rng.integers(1, 4))))
        target.append([_summary(rng, int(rng.integers(1, 5))) for _ in range(int(rng.integers(1, 3)))])
    return preds, target


def _bits(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x, dtype=np.float32).tobytes()


def _assert_dicts_bitwise(got, want, what=""):
    assert sorted(got) == sorted(want), what
    for key in want:
        assert got[key].dtype == torch.float32, (what, key)
        assert _bits(got[key]) == _bits(want[key]), (what, key, float(got[key]), float(want[key]))


ROUGE_CONFIGS = {
    "default": {},
    "avg-all-keys": {"accumulate": "avg", "rouge_keys": tuple(f"rouge{i}" for i in range(1, 10)) + ("rougeL", "rougeLsum")},
    "lsum-only": {"rouge_keys": "rougeLsum"},
    "stemmer": {"use_stemmer": True, "rouge_keys": ("rouge1", "rougeL", "rougeLsum")},
}


def _rouge_kwargs(config):
    if ROUGE_CONFIGS[config].get("use_stemmer") and not _NLTK_AVAILABLE:
        pytest.skip("the stemmer needs nltk")
    return ROUGE_CONFIGS[config]


@pytest.mark.parametrize("config", sorted(ROUGE_CONFIGS))
def test_rouge_functional_is_bitwise(config):
    kwargs = _rouge_kwargs(config)
    preds, target = _rouge_corpus(0, 6)
    _assert_dicts_bitwise(tf.rouge_score(preds, target, **kwargs), jf.rouge_score(preds, target, **kwargs), config)
    flat = [t[0] for t in target]
    _assert_dicts_bitwise(tf.rouge_score(preds, flat, **kwargs), jf.rouge_score(preds, flat, **kwargs), config)
    _assert_dicts_bitwise(tf.rouge_score(preds[0], flat[0], **kwargs), jf.rouge_score(preds[0], flat[0], **kwargs))


@pytest.mark.parametrize("config", sorted(ROUGE_CONFIGS))
def test_rouge_module_streams_bitwise(config):
    kwargs = _rouge_kwargs(config)
    ref, port = jm.ROUGEScore(**kwargs), mt.ROUGEScore(device="cpu", **kwargs)
    ref_fwd, port_fwd = jm.ROUGEScore(**kwargs), mt.ROUGEScore(device="cpu", **kwargs)
    preds, target = _rouge_corpus(1, 9)
    for lo, hi in ((0, 4), (4, 5), (5, 9)):
        ref.update(preds[lo:hi], target[lo:hi])
        port.update(preds[lo:hi], target[lo:hi])
        _assert_dicts_bitwise(port_fwd(preds[lo:hi], target[lo:hi]), ref_fwd(preds[lo:hi], target[lo:hi]), "forward")
    _assert_dicts_bitwise(port.compute(), ref.compute(), config)
    _assert_dicts_bitwise(port_fwd.compute(), ref_fwd.compute(), config)
    for name in port._defaults:
        assert _bits(getattr(port, name)) == np.asarray(getattr(ref, name)).tobytes(), name
    loaded = mt.ROUGEScore(device="cpu", **kwargs)
    mt.load_jax_state(loaded, ref.state_pytree())
    for m in (loaded, ref):
        m.update(preds[:2], target[:2])
    _assert_dicts_bitwise(loaded.compute(), ref.compute(), "loaded")


def test_rouge_state_names_and_the_splitter():
    port = mt.ROUGEScore(rouge_keys=("rouge2", "rougeLsum"), device="cpu")
    assert list(port._defaults) == [f"rouge{k}_{s}_sum" for k in (2, "Lsum") for s in ("fmeasure", "precision", "recall")] + ["total"]
    from metrics_tpu.functional.text.rouge import _split_sentence as jax_split
    from metrics_tpu_torch.functional.text.rouge import _split_sentence

    text = "First one. Second one!\nThird?  Fourth without end"
    assert _split_sentence(text) == jax_split(text)


def test_rouge_argument_checks():
    with pytest.raises(ValueError):
        mt.ROUGEScore(rouge_keys=("rouge10",), device="cpu")
    with pytest.raises(ValueError):
        tf.rouge_score("a", "a", accumulate="sum")


def _squad_corpus(seed, n):
    rng = np.random.default_rng(seed)
    preds, target = [], []
    for q in range(n):
        answers = [" ".join(_WORDS[i] for i in rng.integers(0, len(_WORDS), size=rng.integers(1, 5)))
                   for _ in range(int(rng.integers(1, 4)))]
        if rng.random() < 0.1:
            answers = []
        target.append({"answers": {"answer_start": [0] * len(answers), "text": answers}, "id": f"q{q}"})
        if rng.random() < 0.9:
            base = answers[int(rng.integers(0, len(answers)))] if answers and rng.random() < 0.7 else "the games"
            words = base.split()
            if rng.random() < 0.5:
                words = words + [_WORDS[int(rng.integers(0, len(_WORDS)))]]
            preds.append({"prediction_text": " ".join(words).upper() if rng.random() < 0.2 else " ".join(words),
                          "id": f"q{q}"})
    return preds, target


def test_squad_functional_and_module_are_bitwise():
    preds, target = _squad_corpus(0, 40)
    _assert_dicts_bitwise(tf.squad(preds, target), jf.squad(preds, target), "functional")
    _assert_dicts_bitwise(tf.squad(preds[0], target[0]), jf.squad(preds[0], target[0]), "single")
    ref, port = jm.SQuAD(), mt.SQuAD(device="cpu")
    ref_fwd, port_fwd = jm.SQuAD(), mt.SQuAD(device="cpu")
    for lo, hi in ((0, 15), (15, 16), (16, 40)):
        ids = {t["id"] for t in target[lo:hi]}
        p = [x for x in preds if x["id"] in ids]
        ref.update(p, target[lo:hi])
        port.update(p, target[lo:hi])
        _assert_dicts_bitwise(port_fwd(p, target[lo:hi]), ref_fwd(p, target[lo:hi]), "forward")
    _assert_dicts_bitwise(port.compute(), ref.compute(), "compute")
    for name in ("f1_score", "exact_match", "total"):
        assert _bits(getattr(port, name)) == np.asarray(getattr(ref, name)).tobytes(), name
    loaded = mt.SQuAD(device="cpu")
    mt.load_jax_state(loaded, ref.state_pytree())
    _assert_dicts_bitwise(loaded.compute(), ref.compute(), "loaded")


def test_squad_bad_keys_raise():
    with pytest.raises(KeyError):
        tf.squad([{"wrong": "x", "id": "1"}], [{"answers": {"text": ["x"]}, "id": "1"}])
    with pytest.raises(KeyError):
        mt.SQuAD(device="cpu").update([{"prediction_text": "x", "id": "1"}], [{"answers": {}, "id": "1"}])


def test_an_update_issues_no_tensor_operation():
    rouge, squad = mt.ROUGEScore(device="cpu"), mt.SQuAD(device="cpu")
    preds, target = _rouge_corpus(2, 3)
    sp, st = _squad_corpus(1, 5)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rouge.update(preds, target)
        rouge.update(preds, target)
        squad.update(sp, st)
        squad.update(sp, st)
    assert [e.name for e in prof.events() if e.name.startswith("aten::")] == []
