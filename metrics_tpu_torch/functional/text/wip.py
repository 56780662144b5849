"""Word information preserved (counterpart of ``metrics_tpu/functional/text/wip.py``)."""

from typing import List, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.functional.text.helper import _as_tensor, _edit_distance_batch, _host_f32, _normalize_str_list


def _wip_update(
    preds: Union[str, List[str]], target: Union[str, List[str]]
) -> Tuple[np.float32, np.float32, np.float32]:
    """(distance - max_len, total ref words, total pred words), host float32 numbers."""
    preds = _normalize_str_list(preds)
    target = _normalize_str_list(target)
    pred_tok = [p.split() for p in preds]
    tgt_tok = [t.split() for t in target]
    errors = int(_edit_distance_batch(pred_tok, tgt_tok).sum())
    total = sum(max(len(t), len(p)) for t, p in zip(tgt_tok, pred_tok))
    target_total = sum(len(t) for t in tgt_tok)
    preds_total = sum(len(p) for p in pred_tok)
    return _host_f32(errors - total, target_total, preds_total)


def _wip_compute(errors, target_total, preds_total) -> torch.Tensor:
    errors = _as_tensor(errors)
    return (errors / _as_tensor(target_total)) * (errors / _as_tensor(preds_total))


def word_information_preserved(preds: Union[str, List[str]], target: Union[str, List[str]]) -> torch.Tensor:
    """Word information preserved, ``(H/N_ref) * (H/N_pred)`` (a float32 CPU tensor).

    Example:
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> round(float(word_information_preserved(preds, target)), 4)
        0.3472
    """
    errors, target_total, preds_total = _wip_update(preds, target)
    return _wip_compute(errors, target_total, preds_total)
