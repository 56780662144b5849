"""STOI (counterpart of ``metrics_tpu/functional/audio/stoi.py``).

Short-Time Objective Intelligibility through the optional ``pystoi`` package,
one signal at a time on the host, as in the JAX package; the functional
raises where it is not installed.
"""

import numpy as np
import torch

from metrics_tpu_torch.functional.audio.pesq import _host_rows
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.imports import _PYSTOI_AVAILABLE

_PYSTOI_MISSING = (
    "STOI metric requires that `pystoi` is installed. It is not bundled with this "
    "offline build; install `pystoi` to enable it."
)


def short_time_objective_intelligibility(
    preds: torch.Tensor,
    target: torch.Tensor,
    fs: int,
    extended: bool = False,
    keep_same_device: bool = False,
) -> torch.Tensor:
    """STOI score per signal (batched over leading dims), a float32 tensor on the inputs' device."""
    if not _PYSTOI_AVAILABLE:
        raise ModuleNotFoundError(_PYSTOI_MISSING)
    from pystoi import stoi as stoi_backend

    _check_same_shape(preds, target)
    preds_np, target_np = _host_rows(preds), _host_rows(target)
    vals = np.asarray([stoi_backend(t, p, fs, extended) for p, t in zip(preds_np, target_np)])
    return torch.as_tensor(vals, dtype=torch.float32, device=preds.device).reshape(preds.shape[:-1])
