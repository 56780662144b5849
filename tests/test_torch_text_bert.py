"""The port's WordPiece tokenizer and BERTScore against the JAX package.

* ``WordPieceTokenizer`` and ``build_wordpiece_vocab``: the same vocabulary,
  pieces and ids as the JAX package's on a seeded corpus with accents,
  punctuation, CJK characters and control characters.
* BERTScore through the own-model path with the toy embedding model of the
  JAX package's tests (a fixed numpy table, the same on both sides): the
  functional, the module's streaming, ``idf``, ``rescale_with_baseline`` and
  ``return_hash``; token states bitwise, scores within ``ATOL``.
* A tiny ``FlaxBertModel`` (seed 0) on the JAX side against ``transformers``'
  PyTorch ``BertModel`` given the same parameters through
  ``load_flax_weights_in_pytorch_model``: the last layer, ``num_layers``,
  ``all_layers`` and ``idf``, within ``HF_ATOL`` (the two encoders agree to
  about 1e-6 on these inputs).
* The eager-encode cache gives the full encode's result, and each
  invalidation path (``forward``, ``reset``, ``load_state_dict``,
  ``load_state_pytree``, swapped state lists) drops it.
"""

import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.functional as jf
import metrics_tpu_torch as mt
import metrics_tpu_torch.functional as tf
from metrics_tpu.functional.text.wordpiece import WordPieceTokenizer as JaxWordPiece
from metrics_tpu.functional.text.wordpiece import build_wordpiece_vocab as jax_build_vocab
from metrics_tpu_torch.functional.text.wordpiece import WordPieceTokenizer, build_wordpiece_vocab

ATOL = 1e-6  # cosines of float32 unit rows: the two matmuls add in other orders
HF_ATOL = 2e-5  # plus the two encoders' own float32 differences
_WORDS = ("Café", "naïve", "running", "runner", "runs", "the", "quick", "brown", "fox", "jumps", "über",
          "don't", "U.S.A.", "3.14", "e-mail", "東京", "에서", "!!", "(hello)", "tab\there", "zero​width")


def _corpus(seed, n, lo=3, hi=12):
    rng = np.random.default_rng(seed)
    return [" ".join(_WORDS[i] for i in rng.integers(0, len(_WORDS), size=rng.integers(lo, hi))) for _ in range(n)]


def _pairs(seed, n):
    preds, target = _corpus(seed, n), _corpus(seed + 100, n)
    return preds, target


def test_wordpiece_vocab_pieces_and_ids_equal_the_jax_package():
    corpus = _corpus(0, 60)
    for size, lower in ((400, True), (60, False)):
        vocab = build_wordpiece_vocab(corpus, size=size, do_lower_case=lower)
        assert vocab == jax_build_vocab(corpus, size=size, do_lower_case=lower)
        tok, ref = WordPieceTokenizer(vocab, do_lower_case=lower), JaxWordPiece(vocab, do_lower_case=lower)
        texts = _corpus(1, 20) + ["", "\x00control\x07", "a" * 150]
        for text in texts:
            assert tok.tokenize(text) == ref.tokenize(text)
        for kwargs in ({"max_length": 12}, {"max_length": 40, "padding": False}, {"max_length": 8, "truncation": False}):
            assert tok(texts, **kwargs) == ref(texts, **kwargs)


def test_wordpiece_reads_a_vocab_file_and_checks_specials(tmp_path):
    vocab = build_wordpiece_vocab(_corpus(2, 20), size=100)
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n", encoding="utf-8")
    assert WordPieceTokenizer(str(path)).vocab == JaxWordPiece(str(path)).vocab
    with pytest.raises(ValueError):
        WordPieceTokenizer(["[PAD]", "[UNK]", "[CLS]"])


class _ToyTokenizer:
    """Deterministic hash tokenizer (no external data)."""

    def __call__(self, texts, padding=None, max_length=16, truncation=True, return_attention_mask=True):
        ids, masks = [], []
        for t in texts:
            toks = [(hash(w) % 977) + 1 for w in t.split()][:max_length]
            pad = max_length - len(toks)
            ids.append(toks + [0] * pad)
            masks.append([1] * len(toks) + [0] * pad)
        return {"input_ids": ids, "attention_mask": masks}


class _ToyModel:
    """Embedding = a fixed random table lookup (the JAX package's test model)."""

    def __init__(self, dim=8):
        self.table = np.random.default_rng(42).normal(size=(978, dim)).astype(np.float32)

    def embed(self, ids):
        return self.table[np.asarray(ids)]


def _jax_forward(model, input_ids, attention_mask):
    return model.embed(input_ids)


def _port_forward(model, input_ids, attention_mask):
    return model.embed(input_ids.cpu().numpy())


def _toy_args(port: bool):
    return dict(model=_ToyModel(), user_tokenizer=_ToyTokenizer(),
                user_forward_fn=_port_forward if port else _jax_forward, max_length=16)


def _assert_scores(got, want, atol, what=""):
    for key in ("precision", "recall", "f1"):
        g, w = np.asarray(got[key], np.float64), np.asarray(want[key], np.float64)
        assert g.shape == w.shape, (what, key)
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=f"{what} {key}")


@pytest.mark.parametrize("idf", [False, True])
def test_toy_model_functional_matches_the_jax_package(idf):
    preds, target = _pairs(3, 7)
    got = tf.bert_score(preds, target, idf=idf, **_toy_args(True))
    want = jf.bert_score(preds, target, idf=idf, **_toy_args(False))
    _assert_scores(got, want, ATOL, f"idf={idf}")
    baseline = {"precision": 0.1, "recall": 0.2, "f1": 0.15}
    got = tf.bert_score(preds, target, rescale_with_baseline=True, baseline_values=baseline, return_hash=True,
                        **_toy_args(True))
    want = jf.bert_score(preds, target, rescale_with_baseline=True, baseline_values=baseline, return_hash=True,
                         **_toy_args(False))
    _assert_scores(got, want, 4 * ATOL, "rescaled")
    assert got["hash"] == want["hash"]
    with pytest.raises(ValueError):
        tf.bert_score(preds, target, rescale_with_baseline=True, **_toy_args(True))


def test_toy_model_module_streams_like_the_jax_package():
    ref, port = jm.BERTScore(**_toy_args(False)), mt.BERTScore(device="cpu", **_toy_args(True))
    preds, target = _pairs(4, 9)
    for lo, hi in ((0, 1), (1, 5), (5, 9)):
        ref.update(preds[lo:hi], target[lo:hi])
        port.update(preds[lo:hi], target[lo:hi])
    _assert_scores(port.compute(), ref.compute(), ATOL, "module")
    for name in ("preds_input_ids", "preds_attention_mask", "target_input_ids", "target_attention_mask"):
        got, want = getattr(port, name), getattr(ref, name)
        assert len(got) == len(want) == 3
        assert all(g.dtype == torch.int32 and g.numpy().tobytes() == np.asarray(w).tobytes() for g, w in zip(got, want))
    loaded = mt.BERTScore(device="cpu", **_toy_args(True))
    mt.load_jax_state(loaded, ref.state_pytree())
    for m in (loaded, ref):
        m.update(preds[:2], target[:2])
    _assert_scores(loaded.compute(), ref.compute(), ATOL, "loaded")
    fwd_ref, fwd_port = jm.BERTScore(**_toy_args(False)), mt.BERTScore(device="cpu", **_toy_args(True))
    _assert_scores(fwd_port(preds[:3], target[:3]), fwd_ref(preds[:3], target[:3]), ATOL, "forward")
    assert "model" not in dict(port.named_modules()) and not list(port.state_dict())


def test_missing_model_and_tokenizer_raise():
    with pytest.raises(ValueError):
        tf.bert_score(["a"], ["a"])
    with pytest.raises(ValueError):
        mt.BERTScore(model=_ToyModel(), device="cpu")
    with pytest.raises(ValueError):
        tf.bert_score(["a", "b"], ["a"], **_toy_args(True))


# ------------------------------------------------------- a real BERT encoder
def _hf_pair():
    transformers = pytest.importorskip("transformers")
    from transformers import BertConfig, BertModel, FlaxBertModel
    from transformers.modeling_flax_pytorch_utils import load_flax_weights_in_pytorch_model

    transformers.logging.set_verbosity_error()
    cfg = BertConfig(vocab_size=97, hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
                     intermediate_size=32, max_position_embeddings=32)
    flax_model = FlaxBertModel(cfg, seed=0)
    torch_model = load_flax_weights_in_pytorch_model(BertModel(cfg), flax_model.params).eval()
    return flax_model, torch_model


class _HashTok:
    def __call__(self, texts, padding=None, max_length=16, truncation=True, return_attention_mask=True):
        ids = [[(hash(w) % 95) + 1 for w in t.split()][:max_length] for t in texts]
        return {
            "input_ids": [i + [0] * (max_length - len(i)) for i in ids],
            "attention_mask": [[1] * len(i) + [0] * (max_length - len(i)) for i in ids],
        }


@pytest.fixture(scope="module")
def hf_models():
    return _hf_pair()


HF_PATHS = {"last": {}, "layer1": {"num_layers": 1}, "all_layers": {"all_layers": True},
            "idf-layer2": {"idf": True, "num_layers": 2}}


@pytest.mark.parametrize("path", sorted(HF_PATHS))
def test_hf_encoder_functional_matches_the_jax_package(hf_models, path):
    flax_model, torch_model = hf_models
    preds, target = _pairs(5, 5)
    kwargs = dict(HF_PATHS[path], user_tokenizer=_HashTok(), max_length=16, batch_size=2)
    got = tf.bert_score(preds, target, model=torch_model, **kwargs)
    want = jf.bert_score(preds, target, model=flax_model, **kwargs)
    _assert_scores(got, want, HF_ATOL, path)
    if path == "all_layers":
        assert np.asarray(got["f1"]).shape == (3, 5)  # the embeddings and two layers


def test_hf_encoder_module_matches_the_jax_package(hf_models):
    flax_model, torch_model = hf_models
    preds, target = _pairs(6, 6)
    ref = jm.BERTScore(model=flax_model, user_tokenizer=_HashTok(), max_length=16, batch_size=2, num_layers=1)
    port = mt.BERTScore(model=torch_model, user_tokenizer=_HashTok(), max_length=16, batch_size=2, num_layers=1,
                        device="cpu")
    for lo, hi in ((0, 3), (3, 4), (4, 6)):
        ref.update(preds[lo:hi], target[lo:hi])
        port.update(preds[lo:hi], target[lo:hi])
    assert len(port._enc_src) >= 1  # encodes ran during the updates
    _assert_scores(port.compute(), ref.compute(), HF_ATOL, "module")


def test_model_name_or_path_loads_local_files(hf_models, tmp_path):
    from transformers import BertTokenizer

    _, torch_model = hf_models
    vocab = build_wordpiece_vocab(_corpus(7, 40), size=97)
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n", encoding="utf-8")
    BertTokenizer(str(tmp_path / "vocab.txt")).save_pretrained(tmp_path)
    torch_model.save_pretrained(tmp_path)
    preds, target = _pairs(8, 3)
    got = tf.bert_score(preds, target, model_name_or_path=str(tmp_path), max_length=16, return_hash=True)
    want = tf.bert_score(preds, target, model=torch_model, user_tokenizer=BertTokenizer.from_pretrained(tmp_path),
                         max_length=16)
    _assert_scores(got, want, 0.0, "local checkpoint")
    assert got["hash"] == f"metrics_tpu-bert_score-{tmp_path}"
    with pytest.raises((OSError, ValueError)):  # nothing to load, and no download
        tf.bert_score(preds, target, model_name_or_path=str(tmp_path / "missing"))


def test_without_transformers_the_name_path_names_the_own_model_path(monkeypatch):
    import metrics_tpu_torch.functional.text.bert as bert

    monkeypatch.setattr(bert, "_TRANSFORMERS_AVAILABLE", False)
    with pytest.raises(ModuleNotFoundError, match="user_tokenizer"):
        tf.bert_score(["a"], ["a"], model_name_or_path="roberta-large")


# --------------------------------------------------------- eager-encode cache
def _cached_metric(torch_model, **kwargs):
    return mt.BERTScore(model=torch_model, user_tokenizer=_HashTok(), max_length=16, batch_size=3, device="cpu",
                        **kwargs)


def _full_encode(metric):
    metric._invalidate_encoder_cache()
    return metric.compute()


@pytest.mark.parametrize("kwargs", [{}, {"all_layers": True}, {"idf": True, "num_layers": 1}], ids=["last", "all", "idf"])
def test_the_cache_gives_the_full_encodes_result(hf_models, kwargs):
    _, torch_model = hf_models
    preds, target = _pairs(9, 8)
    metric = _cached_metric(torch_model, **kwargs)
    for lo, hi in ((0, 2), (2, 4), (4, 5), (5, 8)):
        metric.update(preds[lo:hi], target[lo:hi])
    assert len(metric._enc_src) == 4  # [0:2]+[2:4] encoded once 4 rows waited, [4:5]+[5:8] once 4 more did
    metric.profile_compute = True
    cached = metric.compute()
    assert metric.last_compute_breakdown["encoder_cached_chunks"] == 2
    assert {"concat_secs", "encoder_secs", "idf_secs", "matching_secs", "fetch_secs"} <= set(metric.last_compute_breakdown)
    metric._computed = None
    _assert_scores(cached, _full_encode(metric), 1e-6, "cache")


def test_each_invalidation_path_drops_the_cache(hf_models):
    _, torch_model = hf_models
    preds, target = _pairs(10, 6)

    def primed():
        m = _cached_metric(torch_model)
        m.update(preds[:3], target[:3])
        assert len(m._enc_src) == 1 and m._enc_cache["p"]
        return m

    m = primed()
    m.reset()
    assert m._enc_src == [] and m._enc_cache == {"p": [], "t": []}
    m = primed()
    m.persistent(True)
    m.load_state_dict(m.state_dict())
    assert m._enc_src == []
    m = primed()
    m.load_state_pytree(m.state_pytree())
    assert m._enc_src == []
    m = primed()
    m(preds[3:4], target[3:4])
    assert m._enc_src == [] and len(m.preds_input_ids) == 2
    # swapped lists (as a sync gather leaves them): the next update restarts the cache
    m = primed()
    full = _cached_metric(torch_model)
    full.update(preds[:3], target[:3])
    for metric in (m, full):
        metric.update(preds[3:5], target[3:5])
    m.preds_input_ids = [t.clone() for t in m.preds_input_ids]
    assert not m._cache_is_prefix()
    m.update(preds[5:6], target[5:6])
    full.update(preds[5:6], target[5:6])
    assert m._cache_is_prefix()
    _assert_scores(m.compute(), _full_encode(full), 1e-6, "swapped")
    # without profiling nothing is recorded
    assert m.last_compute_breakdown == {}
