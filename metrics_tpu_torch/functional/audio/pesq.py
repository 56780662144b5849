"""PESQ (counterpart of ``metrics_tpu/functional/audio/pesq.py``).

ITU-T P.862 is a host DSP pipeline: as in the JAX package, the scores come
from the optional ``pesq`` C extension, one signal at a time on the host, and
the functional raises where it is not installed.
"""

import numpy as np
import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.imports import _PESQ_AVAILABLE

_PESQ_MISSING = (
    "PESQ metric requires that `pesq` is installed. It is not bundled with this "
    "offline build; install `pesq` to enable it."
)


def _host_rows(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().reshape(-1, x.shape[-1])


def perceptual_evaluation_speech_quality(
    preds: torch.Tensor,
    target: torch.Tensor,
    fs: int,
    mode: str,
    keep_same_device: bool = False,
) -> torch.Tensor:
    """PESQ score per signal (batched over leading dims), a float32 tensor on the inputs' device."""
    if not _PESQ_AVAILABLE:
        raise ModuleNotFoundError(_PESQ_MISSING)
    import pesq as pesq_backend

    if fs not in (8000, 16000):
        raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
    if mode not in ("wb", "nb"):
        raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
    _check_same_shape(preds, target)
    preds_np, target_np = _host_rows(preds), _host_rows(target)
    vals = np.asarray([pesq_backend.pesq(fs, t, p, mode) for p, t in zip(preds_np, target_np)])
    return torch.as_tensor(vals, dtype=torch.float32, device=preds.device).reshape(preds.shape[:-1])
