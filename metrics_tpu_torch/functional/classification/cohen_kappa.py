"""Cohen's kappa functional (counterpart of ``metrics_tpu/functional/classification/cohen_kappa.py``)."""

from typing import Optional

import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import _confusion_matrix_update

_cohen_kappa_update = _confusion_matrix_update


def _cohen_kappa_compute(confmat: torch.Tensor, weights: Optional[str] = None) -> torch.Tensor:
    """float32 kappa from a ``(C, C)`` confusion matrix.

    The expected matrix is the outer product of the row and column sums.  The
    JAX package forms it as a ``(C, 1) @ (1, C)`` matmul; with one term per
    entry that is one rounded product, which a broadcast multiply gives bit
    for bit, whatever a user sets for TF32 matmuls.
    """
    confmat = confmat.to(torch.float32)
    n_classes = confmat.shape[0]
    sum0 = confmat.sum(0, keepdim=True)
    sum1 = confmat.sum(1, keepdim=True)
    expected = sum1 * sum0 / sum0.sum()

    if weights is None:
        w_mat = torch.ones_like(confmat) - torch.eye(n_classes, dtype=confmat.dtype, device=confmat.device)
    elif weights in ("linear", "quadratic"):
        w_mat = torch.arange(n_classes, dtype=confmat.dtype, device=confmat.device).expand(n_classes, n_classes)
        if weights == "linear":
            w_mat = torch.abs(w_mat - w_mat.T)
        else:
            w_mat = torch.pow(w_mat - w_mat.T, 2.0)
    else:
        raise ValueError(
            f"Received {weights} for argument ``weights`` but should be either None, 'linear' or 'quadratic'"
        )
    k = (w_mat * confmat).sum() / (w_mat * expected).sum()
    return 1 - k


def cohen_kappa(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    weights: Optional[str] = None,
    threshold: float = 0.5,
    validate_args: bool = True,
) -> torch.Tensor:
    """Cohen's kappa, on the device of the inputs.

    Example:
        >>> import torch
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0.35, 0.85, 0.48, 0.01])
        >>> float(cohen_kappa(preds, target, num_classes=2))
        0.5
    """
    confmat = _cohen_kappa_update(preds, target, num_classes, threshold, validate_args=validate_args)
    return _cohen_kappa_compute(confmat, weights)
