"""BERTScore (counterpart of ``metrics_tpu/functional/text/bert.py``).

Greedy matching of contextual embeddings (Zhang et al., ICLR 2020).  The
sentences are tokenized on the host into padded int32 rows; the encoder is
any callable: a Hugging Face style PyTorch model (``model(input_ids=,
attention_mask=, output_hidden_states=)`` returning ``.last_hidden_state``
and ``.hidden_states``) or the caller's ``user_forward_fn(model, ids,
mask)``.  The matching runs in float32 on the device of the embeddings:
masked unit rows, one batched cosine product, row and column maxima and
weighted means.  The JAX package jit-compiles its encoder per model and
demotes it to eager calls when a trace fails; the port compiles nothing, so
neither has a counterpart here.
"""

import inspect
import math
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from metrics_tpu_torch.utils.compute import _norm
from metrics_tpu_torch.utils.imports import _TRANSFORMERS_AVAILABLE


def _idf_weights(token_rows: np.ndarray, mask_rows: np.ndarray, num_docs: int) -> Dict[int, float]:
    """Inverse document frequency over the target corpus: ``log((N + 1) / (df + 1))`` per token id."""
    df: Counter = Counter()
    for row, mask in zip(token_rows, mask_rows):
        df.update(set(int(t) for t, m in zip(row, mask) if m))
    return {tok: math.log((num_docs + 1) / (cnt + 1)) for tok, cnt in df.items()}


def _apply_idf(ids: np.ndarray, mask: np.ndarray, idf: Dict[int, float]) -> np.ndarray:
    """The id -> idf lookup over the padded token grid (float32)."""
    uniq, inverse = np.unique(ids, return_inverse=True)
    uniq_w = np.asarray([idf.get(int(t), 0.0) for t in uniq], dtype=np.float32)
    return uniq_w[inverse].reshape(ids.shape) * (mask > 0)


def _greedy_match(
    pred_emb: torch.Tensor,
    pred_mask: torch.Tensor,
    tgt_emb: torch.Tensor,
    tgt_mask: torch.Tensor,
    pred_w: torch.Tensor,
    tgt_w: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """Batched greedy cosine matching in float32.

    Embeddings are ``(B, L, D)``, or ``(K, B, L, D)`` for ``all_layers`` (the
    masks and weights, ``(B, L)``, are shared by the layers); the scores are
    ``(B,)`` or ``(K, B)``.
    """

    def unit_rows(x, m):
        x = x * m[..., None]
        return x / torch.clamp_min(_norm(x, -1, keepdim=True), 1e-12)

    p = unit_rows(pred_emb, pred_mask)
    t = unit_rows(tgt_emb, tgt_mask)
    sim = torch.matmul(p, t.transpose(-1, -2))  # (..., B, Lp, Lt)
    valid = pred_mask[:, :, None] * tgt_mask[:, None, :] > 0
    sim = torch.where(valid, sim, torch.full((), -1e9, dtype=sim.dtype, device=sim.device))
    best_for_pred = sim.amax(-1)
    best_for_tgt = sim.amax(-2)
    pw = pred_w * pred_mask
    tw = tgt_w * tgt_mask
    precision = (best_for_pred * pw).sum(-1) / torch.clamp_min(pw.sum(-1), 1e-12)
    recall = (best_for_tgt * tw).sum(-1) / torch.clamp_min(tw.sum(-1), 1e-12)
    f1 = 2 * precision * recall / torch.clamp_min(precision + recall, 1e-12)
    return {"precision": precision, "recall": recall, "f1": f1}


def _default_tokenize(text: Sequence[str], tokenizer: Any, max_length: int) -> Dict[str, np.ndarray]:
    """A Hugging Face style tokenizer call, as padded int32 numpy rows."""
    enc = tokenizer(
        list(text), padding="max_length", max_length=max_length, truncation=True, return_attention_mask=True
    )
    return {
        "input_ids": np.asarray(enc["input_ids"], dtype=np.int32),
        "attention_mask": np.asarray(enc["attention_mask"], dtype=np.int32),
    }


def _load_model(model_name_or_path: str):
    """``transformers``' PyTorch ``AutoTokenizer``/``AutoModel`` from local files only."""
    if not _TRANSFORMERS_AVAILABLE:
        raise ModuleNotFoundError(
            "`model_name_or_path` needs the `transformers` package. Without it, pass your own encoder: "
            "`model` with `user_tokenizer` (and `user_forward_fn` where the model is not Hugging Face style)."
        )
    from transformers import AutoModel, AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(model_name_or_path, local_files_only=True)
    model = AutoModel.from_pretrained(model_name_or_path, output_hidden_states=True, local_files_only=True)
    model.eval()
    return tokenizer, model


def _model_device(model: Any, default: Union[str, torch.device] = "cpu") -> torch.device:
    """Where the model's parameters live (``default`` for a model without any)."""
    if isinstance(model, torch.nn.Module):
        for param in model.parameters():
            return param.device
    return torch.device(default)


def _as_embeddings(emb: Any) -> torch.Tensor:
    """An encoder's output as a float32 tensor (a tensor stays on its device)."""
    if not isinstance(emb, torch.Tensor):
        emb = torch.as_tensor(np.asarray(emb))
    return emb.to(torch.float32)


def _accepts_hidden_states(model: Any) -> bool:
    fn = model.forward if isinstance(model, torch.nn.Module) else model.__call__
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return True  # cannot introspect: assume Hugging Face style
    return "output_hidden_states" in params or any(p.kind == p.VAR_KEYWORD for p in params.values())


def _model_forward(
    model: Any,
    input_ids: Union[np.ndarray, torch.Tensor],
    attention_mask: Union[np.ndarray, torch.Tensor],
    num_layers: Optional[int],
    all_layers: bool,
    batch_size: int,
) -> torch.Tensor:
    """Embed in chunks of ``batch_size`` rows on the model's device.

    Returns ``(B, L, D)``, or ``(K, B, L, D)`` with ``all_layers``: every
    hidden state is scored on its own.
    """
    need_hidden = all_layers or num_layers is not None
    if need_hidden and not _accepts_hidden_states(model):
        raise ValueError(
            "`num_layers`/`all_layers` need per-layer hidden states, but the model's "
            "__call__ does not accept `output_hidden_states`. Use a model exposing "
            "hidden states or a `user_forward_fn` returning the desired embeddings."
        )
    device = _model_device(model, input_ids.device if isinstance(input_ids, torch.Tensor) else "cpu")
    input_ids = torch.as_tensor(input_ids, device=device)
    attention_mask = torch.as_tensor(attention_mask, device=device)
    kwargs = {"output_hidden_states": True} if need_hidden else {}
    n = input_ids.shape[0]
    bs = batch_size if batch_size > 0 else n
    chunks = []
    with torch.no_grad():
        for s in range(0, n, bs):
            ids = input_ids[s : s + bs].long()
            out = model(input_ids=ids, attention_mask=attention_mask[s : s + bs].long(), **kwargs)
            if need_hidden:
                hidden = getattr(out, "hidden_states", None)
                if hidden is None:
                    raise ValueError(
                        "`num_layers`/`all_layers` need per-layer hidden states, but the model "
                        "returned none despite accepting `output_hidden_states`. Use a model "
                        "exposing hidden states or a `user_forward_fn`."
                    )
                emb = torch.stack(list(hidden), dim=0) if all_layers else hidden[num_layers]
            else:
                emb = out.last_hidden_state
            chunks.append(emb)
    return chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=-3)


def _run_matching(
    p_emb: torch.Tensor,
    p_mask: Union[np.ndarray, torch.Tensor],
    t_emb: torch.Tensor,
    t_mask: Union[np.ndarray, torch.Tensor],
    pw: Union[np.ndarray, torch.Tensor],
    tw: Union[np.ndarray, torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """The matching in float32 on the embeddings' device (a bfloat16 encoder still gets float32 scores)."""
    p_emb, t_emb = _as_embeddings(p_emb), _as_embeddings(t_emb)
    dev = p_emb.device

    def f32(x):
        return torch.as_tensor(x, device=dev).to(torch.float32)

    return _greedy_match(p_emb, f32(p_mask), t_emb.to(dev), f32(t_mask), f32(pw), f32(tw))


def _rescale(out: Dict[str, torch.Tensor], baseline_values: Optional[Dict[str, float]]) -> Dict[str, torch.Tensor]:
    if baseline_values is None:
        raise ValueError(
            "`rescale_with_baseline` needs `baseline_values`: the published baseline files are not bundled."
        )
    return {k: (v - baseline_values[k]) / (1.0 - baseline_values[k]) for k, v in out.items()}


def _bert_hash(model_name_or_path: Optional[str]) -> str:
    return f"metrics_tpu-bert_score-{model_name_or_path or 'user-model'}"


def bert_score(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    model_name_or_path: Optional[str] = None,
    num_layers: Optional[int] = None,
    all_layers: bool = False,
    model: Optional[Any] = None,
    user_tokenizer: Optional[Any] = None,
    user_forward_fn: Optional[Callable] = None,
    verbose: bool = False,
    idf: bool = False,
    max_length: int = 128,
    batch_size: int = 64,
    return_hash: bool = False,
    lang: str = "en",
    rescale_with_baseline: bool = False,
    baseline_values: Optional[Dict[str, float]] = None,
) -> Dict[str, List[float]]:
    """BERTScore precision, recall and F1 per sentence pair.

    Pass ``model_name_or_path`` (a local Hugging Face checkpoint, loaded
    through ``transformers``) or a ``model`` with a ``user_tokenizer`` (and a
    ``user_forward_fn(model, input_ids, attention_mask)`` returning the
    embeddings where the model is not Hugging Face style).  The token rows
    reach the encoder as int tensors on the model's device.
    """
    preds_l = [preds] if isinstance(preds, str) else list(preds)
    target_l = [target] if isinstance(target, str) else list(target)
    if len(preds_l) != len(target_l):
        raise ValueError("Number of predicted and reference sentences must match.")
    if model is None:
        if model_name_or_path is None:
            raise ValueError("Either `model_name_or_path` or a `model` + `user_tokenizer` must be provided.")
        user_tokenizer, model = _load_model(model_name_or_path)
    if user_tokenizer is None:
        raise ValueError("`user_tokenizer` is required when passing an own model.")

    p_tok = _default_tokenize(preds_l, user_tokenizer, max_length)
    t_tok = _default_tokenize(target_l, user_tokenizer, max_length)

    if user_forward_fn is not None:
        device = _model_device(model)
        p_emb = user_forward_fn(
            model, torch.as_tensor(p_tok["input_ids"], device=device), torch.as_tensor(p_tok["attention_mask"], device=device)
        )
        t_emb = user_forward_fn(
            model, torch.as_tensor(t_tok["input_ids"], device=device), torch.as_tensor(t_tok["attention_mask"], device=device)
        )
    else:
        p_emb = _model_forward(model, p_tok["input_ids"], p_tok["attention_mask"], num_layers, all_layers, batch_size)
        t_emb = _model_forward(model, t_tok["input_ids"], t_tok["attention_mask"], num_layers, all_layers, batch_size)

    if idf:
        weights = _idf_weights(t_tok["input_ids"], t_tok["attention_mask"], len(target_l))
        pw = _apply_idf(p_tok["input_ids"], p_tok["attention_mask"], weights)
        tw = _apply_idf(t_tok["input_ids"], t_tok["attention_mask"], weights)
    else:
        pw = np.ones(p_tok["input_ids"].shape, dtype=np.float32)
        tw = np.ones(t_tok["input_ids"].shape, dtype=np.float32)

    out = _run_matching(p_emb, p_tok["attention_mask"], t_emb, t_tok["attention_mask"], pw, tw)
    if rescale_with_baseline:
        out = _rescale(out, baseline_values)
    result = {k: v.cpu().tolist() for k, v in out.items()}
    if return_hash:
        result["hash"] = _bert_hash(model_name_or_path)
    return result
