"""Carry a metric's state across from the JAX package.

:func:`load_jax_state` takes what ``metrics_tpu.Metric.state_pytree()`` or
``.state_dict()`` returns (arrays, read here through ``numpy.asarray``) and
what ``._ckpt_extra_state()`` returns (plain JSON), and loads them into the
matching metric of this package.  It needs neither JAX nor the JAX package.
"""

from typing import Any, Dict, Optional

import numpy as np

from metrics_tpu_torch.metric import Metric


def _as_numpy(value: Any, name: str, default: Any) -> Any:
    if isinstance(value, (list, tuple)):
        return [_as_numpy(v, name, None) for v in value]
    array = np.array(value)  # a writable host copy
    if default is not None and not isinstance(default, list):
        expected = str(default.dtype).replace("torch.", "")
        if array.dtype.name != expected or tuple(array.shape) != tuple(default.shape):
            raise ValueError(
                f"state {name!r}: got {array.dtype.name}{list(array.shape)}, "
                f"the metric holds {expected}{list(default.shape)}"
            )
    return array


def load_jax_state(metric: Metric, state: Dict[str, Any], extra: Optional[Dict[str, Any]] = None) -> None:
    """Load a JAX metric's state (and its checkpoint extras) into ``metric``.

    Every state lands on ``metric.device`` with its dtype kept; a tensor
    state whose dtype or shape differs from the metric's own raises.  A
    buffer state's ``<name>__buf`` may hold any number of rows (trimmed, as
    ``state_pytree`` gives it, or padded, as ``state_dict`` does) and any
    dtype; its ``<name>__len`` says how many are valid.
    ``_update_count``, where ``state`` carries it, and the attributes in
    ``extra`` (such as the locked classification ``mode``) are restored too.
    """
    tree: Dict[str, Any] = {}
    for name, value in state.items():
        if name == "_update_count":
            tree[name] = int(value)
            continue
        if name not in metric._defaults:
            raise KeyError(f"{type(metric).__name__} has no state {name!r}")
        # a buffer's rows grow with the stream: its placeholder default fixes no shape
        default = None if name in metric._buffer_keys() else metric._defaults[name]
        tree[name] = _as_numpy(value, name, default)
    if "_update_count" not in tree:
        tree["_update_count"] = metric._update_count
    metric.load_state_pytree(tree)
    if extra:
        metric._ckpt_load_extra_state(extra)
