"""Rank-aware warn-once helper (counterpart of ``metrics_tpu/obs/logging.py``).

Eager-path warnings inside metric compute/update bodies fire on every call
— and, without rank gating, on every process. ``warn_once`` emits a warning
at most once per process (rank 0 only) and counts suppressions so the obs
report still shows how often the condition recurred.
"""

import threading
import warnings
from typing import Any, Optional, Set, Tuple, Type

import torch.distributed as dist

from metrics_tpu_torch.obs import core as _core

_warned: Set[Tuple[str, ...]] = set()
_lock = threading.Lock()


def _process_index() -> int:
    """This process's rank in ``torch.distributed`` when a group is initialised, else 0."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _clear() -> None:
    with _lock:
        _warned.clear()


_core._reset_hooks.append(_clear)


def warn_once(
    message: str,
    category: Type[Warning] = UserWarning,
    key: Optional[str] = None,
    stacklevel: int = 3,
    **kwargs: Any,
) -> bool:
    """Warn on rank 0, once per process per ``key`` (default: the message).

    Returns True if the warning was newly registered this call. Repeats are
    counted under the ``warn_once.suppressed`` counter instead of re-warning,
    so per-batch degenerate-input warnings cost one line per run, not one per
    rank per step. ``obs.reset()`` clears the registry.
    """
    dedup: Tuple[str, ...] = (category.__name__, key if key is not None else message)
    with _lock:
        if dedup in _warned:
            first = False
        else:
            _warned.add(dedup)
            first = True
    site = key if key is not None else category.__name__
    if not first:
        _core.counter_inc("warn_once.suppressed", site=site)
        return False
    _core.counter_inc("warn_once.emitted", site=site)
    if _process_index() == 0:
        warnings.warn(message, category, stacklevel=stacklevel, **kwargs)
    return True
