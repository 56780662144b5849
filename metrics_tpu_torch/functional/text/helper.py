"""Shared text-metric helpers (counterpart of ``metrics_tpu/functional/text/helper.py``).

Edit distances come from the port's copy of the native C++ library
(:mod:`metrics_tpu_torch._native`, built with ``g++`` at first use; a
pure-Python fallback otherwise).  The per-update statistics are host numbers:
the string metrics touch no device until their states are read.
"""

from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch._native import edit_distance_batch as _edit_distance_batch  # noqa: F401  (per-pair distances)


def _normalize_str_list(x: Union[str, Sequence[str]]) -> List[str]:
    return [x] if isinstance(x, str) else list(x)


def _validate_inputs(
    target_corpus: Union[Sequence[str], Sequence[Sequence[str]]],
    preds_corpus: Union[str, Sequence[str]],
) -> Tuple[Sequence[Sequence[str]], Sequence[str]]:
    """Normalize (target, preds) into (List[List[str]], List[str]).

    A lone hypothesis string is wrapped; a flat list of reference strings
    becomes one reference set per hypothesis (or the reference set of a
    single hypothesis).
    """
    if isinstance(preds_corpus, str):
        preds_corpus = [preds_corpus]
    if all(isinstance(ref, str) for ref in target_corpus):
        if len(preds_corpus) == 1:
            target_corpus = [target_corpus]  # type: ignore[list-item]
        else:
            target_corpus = [[ref] for ref in target_corpus]  # type: ignore[misc]
    if preds_corpus and all(ref for ref in target_corpus) and len(target_corpus) != len(preds_corpus):
        raise ValueError(f"Corpus has different size {len(target_corpus)} != {len(preds_corpus)}")
    return target_corpus, preds_corpus


def _host_f32(*values: int) -> Tuple[np.float32, ...]:
    """Host counts as float32 numbers, as the JAX package's ``jnp.asarray(v, float32)`` rounds them."""
    return tuple(np.float32(v) for v in values)


def _as_tensor(x) -> torch.Tensor:
    """A functional's float32 statistic as a tensor (a state is one already)."""
    return x if isinstance(x, torch.Tensor) else torch.tensor(x, dtype=torch.float32)
