"""BERTScore (counterpart of ``metrics_tpu/text/bert.py``).

An update tokenizes its sentences on the host into padded int32 rows and
appends them to four ``cat`` states on ``device``, so a sync gathers tensors,
never strings.  ``compute()`` embeds the gathered corpus and runs the greedy
matching on the embeddings' device.
"""

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from metrics_tpu_torch.functional.text.bert import (
    _apply_idf,
    _bert_hash,
    _default_tokenize,
    _idf_weights,
    _load_model,
    _model_forward,
    _rescale,
    _run_matching,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat


class BERTScore(Metric):
    """Streaming BERTScore over batches of sentence pairs.

    The encoder is the caller's (``model`` with ``user_tokenizer``, and
    ``user_forward_fn`` where the model is not Hugging Face style) or a local
    ``transformers`` checkpoint (``model_name_or_path``).  It is held as a
    plain attribute, not a submodule: ``state_dict()`` carries the metric's
    token states only.

    Eager encodes: once ``batch_size`` sentences wait, an update encodes the
    stored batches beyond the cached prefix (on the card the launches queue
    behind earlier work while the host tokenizes the next batch).  The cache
    is checked by identity against the live state lists, so a sync, a load or
    any swap of the lists falls back to a full encode at ``compute()``;
    ``forward``, ``reset``, ``load_state_dict`` and ``load_state_pytree``
    drop it.  ``profile_compute = True`` records each phase's seconds in
    ``last_compute_breakdown``, synchronising the card between phases.
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
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
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if model is None:
            if model_name_or_path is None:
                raise ValueError("Either `model_name_or_path` or a `model` + `user_tokenizer` must be provided.")
            user_tokenizer, model = _load_model(model_name_or_path)
        if user_tokenizer is None:
            raise ValueError("`user_tokenizer` is required when passing an own model.")
        object.__setattr__(self, "model", model)  # the caller's encoder, not a submodule
        self.tokenizer = user_tokenizer
        self.user_forward_fn = user_forward_fn
        self.num_layers = num_layers
        self.all_layers = all_layers
        self.idf = idf
        self.max_length = max_length
        self.batch_size = batch_size
        self.return_hash = return_hash
        self.model_name_or_path = model_name_or_path
        self.rescale_with_baseline = rescale_with_baseline
        self.baseline_values = baseline_values
        self.add_state("preds_input_ids", default=[], dist_reduce_fx="cat")
        self.add_state("preds_attention_mask", default=[], dist_reduce_fx="cat")
        self.add_state("target_input_ids", default=[], dist_reduce_fx="cat")
        self.add_state("target_attention_mask", default=[], dist_reduce_fx="cat")
        self._enc_src: List[torch.Tensor] = []  # the stored batches the cache covers, by identity
        self._enc_cache: Dict[str, List[torch.Tensor]] = {"p": [], "t": []}
        self._in_forward_batch = False
        self.profile_compute = False
        self.last_compute_breakdown: Dict[str, float] = {}

    # ------------------------------------------------------ eager-encode cache
    def _invalidate_encoder_cache(self) -> None:
        self._enc_src = []
        self._enc_cache = {"p": [], "t": []}

    def reset(self) -> None:
        self._invalidate_encoder_cache()
        super().reset()

    def load_state_dict(self, *args: Any, **kwargs: Any) -> Any:
        self._invalidate_encoder_cache()
        return super().load_state_dict(*args, **kwargs)

    def load_state_pytree(self, tree: Dict[str, Any]) -> None:
        self._invalidate_encoder_cache()
        super().load_state_pytree(tree)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """``forward`` swaps the states for the batch's: no eager encode of the
        batch (it would be thrown away with the swapped states), and the cache
        goes afterwards (the merged lists no longer match its prefix)."""
        self._in_forward_batch = True
        try:
            return super().forward(*args, **kwargs)
        finally:
            self._in_forward_batch = False
            self._invalidate_encoder_cache()

    def _cache_is_prefix(self) -> bool:
        stored = self.preds_input_ids
        src = self._enc_src
        return len(src) <= len(stored) and all(a is b for a, b in zip(src, stored))

    def _encode_block(self, ids_list: List[torch.Tensor], mask_list: List[torch.Tensor], side: str) -> None:
        emb = _model_forward(
            self.model, torch.cat(ids_list), torch.cat(mask_list), self.num_layers, self.all_layers, self.batch_size
        )
        self._enc_cache[side].append(emb)

    def _encode_pending(self, min_rows: int) -> None:
        """Encode every stored batch beyond the cached prefix once ``min_rows`` sentences wait."""
        start = len(self._enc_src)
        pend = self.preds_input_ids[start:]
        if not pend or sum(int(x.shape[0]) for x in pend) < min_rows:
            return
        self._encode_block(pend, self.preds_attention_mask[start:], "p")
        self._encode_block(self.target_input_ids[start:], self.target_attention_mask[start:], "t")
        self._enc_src.extend(pend)

    # ----------------------------------------------------------------- update
    def update(self, preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> None:
        preds_l = [preds] if isinstance(preds, str) else list(preds)
        target_l = [target] if isinstance(target, str) else list(target)
        if len(preds_l) != len(target_l):
            raise ValueError("Number of predicted and reference sentences must match.")
        p_tok = _default_tokenize(preds_l, self.tokenizer, self.max_length)
        t_tok = _default_tokenize(target_l, self.tokenizer, self.max_length)
        dev = self._list_device
        self.preds_input_ids.append(torch.as_tensor(p_tok["input_ids"], device=dev))
        self.preds_attention_mask.append(torch.as_tensor(p_tok["attention_mask"], device=dev))
        self.target_input_ids.append(torch.as_tensor(t_tok["input_ids"], device=dev))
        self.target_attention_mask.append(torch.as_tensor(t_tok["attention_mask"], device=dev))
        if self.user_forward_fn is None and not self._in_forward_batch:
            if self._cache_is_prefix():
                self._encode_pending(max(1, self.batch_size))
            else:
                # the lists were swapped under the cache (a sync gather, a
                # load): drop it; it restarts from the live lists
                self._invalidate_encoder_cache()

    # ---------------------------------------------------------------- compute
    def _sync_device(self, *tensors: torch.Tensor) -> None:
        for t in tensors:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                torch.cuda.synchronize(t.device)
                return

    def compute(self) -> Dict[str, Any]:
        profile = self.profile_compute
        breakdown: Dict[str, float] = {}
        clock = [time.perf_counter()]

        def tick(key: str, *barrier: torch.Tensor) -> None:
            if profile:
                self._sync_device(*barrier)
                now = time.perf_counter()
                breakdown[key] = now - clock[0]
                clock[0] = now

        p_ids = dim_zero_cat(self.preds_input_ids)
        p_mask = dim_zero_cat(self.preds_attention_mask)
        t_ids = dim_zero_cat(self.target_input_ids)
        t_mask = dim_zero_cat(self.target_attention_mask)
        tick("concat_secs", p_ids, p_mask, t_ids, t_mask)

        if self.user_forward_fn is not None:
            p_emb = self.user_forward_fn(self.model, p_ids, p_mask)
            t_emb = self.user_forward_fn(self.model, t_ids, t_mask)
        elif self._cache_is_prefix() and self._enc_src:
            self._encode_pending(1)  # the tail the updates left
            p_chunks, t_chunks = self._enc_cache["p"], self._enc_cache["t"]
            p_emb = p_chunks[0] if len(p_chunks) == 1 else torch.cat(p_chunks, dim=-3)
            t_emb = t_chunks[0] if len(t_chunks) == 1 else torch.cat(t_chunks, dim=-3)
            breakdown["encoder_cached_chunks"] = len(p_chunks)
        else:
            p_emb = _model_forward(self.model, p_ids, p_mask, self.num_layers, self.all_layers, self.batch_size)
            t_emb = _model_forward(self.model, t_ids, t_mask, self.num_layers, self.all_layers, self.batch_size)
        tick("encoder_secs", p_emb, t_emb)

        if self.idf:
            p_ids_np, p_mask_np = p_ids.cpu().numpy(), p_mask.cpu().numpy()
            t_ids_np, t_mask_np = t_ids.cpu().numpy(), t_mask.cpu().numpy()
            weights = _idf_weights(t_ids_np, t_mask_np, t_ids_np.shape[0])
            pw = _apply_idf(p_ids_np, p_mask_np, weights)
            tw = _apply_idf(t_ids_np, t_mask_np, weights)
        else:
            pw = torch.ones(p_ids.shape, dtype=torch.float32, device=p_ids.device)
            tw = torch.ones(t_ids.shape, dtype=torch.float32, device=t_ids.device)
        tick("idf_secs")

        out = _run_matching(p_emb, p_mask, t_emb, t_mask, pw, tw)
        if self.rescale_with_baseline:
            out = _rescale(out, self.baseline_values)
        tick("matching_secs", *out.values())
        keys = list(out)
        stacked = torch.stack([out[k] for k in keys]).cpu()  # one device -> host copy
        result: Dict[str, Any] = {k: stacked[i].tolist() for i, k in enumerate(keys)}
        tick("fetch_secs")
        if profile:
            self.last_compute_breakdown = breakdown
        if self.return_hash:
            result["hash"] = _bert_hash(self.model_name_or_path)
        return result
