"""Match error rate (counterpart of ``metrics_tpu/functional/text/mer.py``)."""

from typing import List, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.functional.text.helper import _as_tensor, _edit_distance_batch, _host_f32, _normalize_str_list


def _mer_update(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tuple[np.float32, np.float32]:
    """Sum of edit distances and sum of max(len(ref), len(pred)) per pair (host float32 numbers)."""
    preds = _normalize_str_list(preds)
    target = _normalize_str_list(target)
    pred_tok = [p.split() for p in preds]
    tgt_tok = [t.split() for t in target]
    errors = int(_edit_distance_batch(pred_tok, tgt_tok).sum())
    total = sum(max(len(t), len(p)) for t, p in zip(tgt_tok, pred_tok))
    return _host_f32(errors, total)


def _mer_compute(errors, total) -> torch.Tensor:
    return _as_tensor(errors) / _as_tensor(total)


def match_error_rate(preds: Union[str, List[str]], target: Union[str, List[str]]) -> torch.Tensor:
    """Match error rate (a float32 CPU tensor).

    Example:
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> round(float(match_error_rate(preds=preds, target=target)), 4)
        0.4444
    """
    errors, total = _mer_update(preds, target)
    return _mer_compute(errors, total)
