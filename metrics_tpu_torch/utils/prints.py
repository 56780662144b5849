"""Rank-zero printing and warn-once (counterparts of ``metrics_tpu/utils/prints.py``
and ``metrics_tpu/obs/logging.py::warn_once``).

The process index comes from ``torch.distributed`` when a process group is
initialised, else it is 0.  ``warn_once`` lives in :mod:`metrics_tpu_torch.obs.logging`
(it counts what it suppresses) and is re-exported here for its callers.
"""

import logging
import warnings
from functools import wraps
from typing import Any, Callable

from metrics_tpu_torch.obs.logging import _process_index, warn_once

__all__ = ["_process_index", "rank_zero_debug", "rank_zero_info", "rank_zero_only", "rank_zero_warn", "warn_once"]

log = logging.getLogger("metrics_tpu_torch")


def rank_zero_only(fn: Callable) -> Callable:
    @wraps(fn)
    def wrapped_fn(*args: Any, **kwargs: Any) -> Any:
        if _process_index() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapped_fn


@rank_zero_only
def rank_zero_warn(message: str, *args: Any, stacklevel: int = 4, **kwargs: Any) -> None:
    warnings.warn(message, *args, stacklevel=stacklevel, **kwargs)


@rank_zero_only
def rank_zero_info(message: str, *args: Any, **kwargs: Any) -> None:
    log.info(message, *args, **kwargs)


@rank_zero_only
def rank_zero_debug(message: str, *args: Any, **kwargs: Any) -> None:
    log.debug(message, *args, **kwargs)
