"""Character error rate (counterpart of ``metrics_tpu/functional/text/cer.py``)."""

from typing import List, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.functional.text.helper import _as_tensor, _edit_distance_batch, _host_f32, _normalize_str_list


def _cer_update(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tuple[np.float32, np.float32]:
    """Sum of character-level edit distances and total reference characters (host float32 numbers)."""
    preds = _normalize_str_list(preds)
    target = _normalize_str_list(target)
    pred_chars = [list(p) for p in preds]
    tgt_chars = [list(t) for t in target]
    errors = int(_edit_distance_batch(pred_chars, tgt_chars).sum())
    total = sum(len(t) for t in tgt_chars)
    return _host_f32(errors, total)


def _cer_compute(errors, total) -> torch.Tensor:
    return _as_tensor(errors) / _as_tensor(total)


def char_error_rate(preds: Union[str, List[str]], target: Union[str, List[str]]) -> torch.Tensor:
    """Character error rate (a float32 CPU tensor).

    Example:
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> round(float(char_error_rate(preds=preds, target=target)), 4)
        0.3415
    """
    errors, total = _cer_update(preds, target)
    return _cer_compute(errors, total)
