"""Rank-zero printing and warn-once (counterparts of ``metrics_tpu/utils/prints.py``
and ``metrics_tpu/obs/logging.py::warn_once``).

The process index comes from ``torch.distributed`` when a process group is
initialised, else it is 0.
"""

import threading
import warnings
from functools import wraps
from typing import Any, Callable, Optional, Set, Tuple, Type

import torch.distributed as dist


def _process_index() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


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


_warned: Set[Tuple[str, ...]] = set()
_lock = threading.Lock()


def warn_once(
    message: str,
    category: Type[Warning] = UserWarning,
    key: Optional[str] = None,
    stacklevel: int = 3,
    **kwargs: Any,
) -> bool:
    """Warn on rank 0, once per process per ``key`` (default: the message).

    Returns True if the warning was newly registered this call.
    """
    dedup: Tuple[str, ...] = (category.__name__, key if key is not None else message)
    with _lock:
        if dedup in _warned:
            return False
        _warned.add(dedup)
    if _process_index() == 0:
        warnings.warn(message, category, stacklevel=stacklevel, **kwargs)
    return True
