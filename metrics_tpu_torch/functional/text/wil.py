"""Word information lost (counterpart of ``metrics_tpu/functional/text/wil.py``)."""

from typing import List, Union

import torch

# WIL and WIP share the accumulator (distance - max_len == -hits); WIL is 1 - WIP
from metrics_tpu_torch.functional.text.wip import _wip_compute
from metrics_tpu_torch.functional.text.wip import _wip_update as _wil_update


def _wil_compute(errors, target_total, preds_total) -> torch.Tensor:
    return 1 - _wip_compute(errors, target_total, preds_total)


def word_information_lost(preds: Union[str, List[str]], target: Union[str, List[str]]) -> torch.Tensor:
    """Word information lost, ``1 - WIP`` (a float32 CPU tensor).

    Example:
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> round(float(word_information_lost(preds, target)), 4)
        0.6528
    """
    errors, target_total, preds_total = _wil_update(preds, target)
    return _wil_compute(errors, target_total, preds_total)
