"""image_gradients (counterpart of ``metrics_tpu/functional/image/gradients.py``)."""

from typing import Tuple

import torch
import torch.nn.functional as F

from metrics_tpu_torch.utils.checks import _as_tensor


def _image_gradients_validate(img: torch.Tensor) -> None:
    if img.ndim != 4:
        raise RuntimeError(f"The `img` expects a 4D tensor but got {img.ndim}D tensor.")


def _compute_image_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-step finite differences, zero-padded on the far edge."""
    dy = img[..., 1:, :] - img[..., :-1, :]
    dx = img[..., :, 1:] - img[..., :, :-1]
    return F.pad(dy, (0, 0, 0, 1)), F.pad(dx, (0, 1, 0, 0))


def image_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dy, dx) finite-difference gradients of an (N, C, H, W) image batch, on its device.

    Example:
        >>> import torch
        >>> image = torch.arange(0, 25, dtype=torch.float32).reshape(1, 1, 5, 5)
        >>> dy, dx = image_gradients(image)
        >>> dy[0, 0, 0, :]
        tensor([5., 5., 5., 5., 5.])
    """
    img = _as_tensor(img)
    _image_gradients_validate(img)
    return _compute_image_gradients(img)
