"""Matthews correlation coefficient functional
(counterpart of ``metrics_tpu/functional/classification/matthews_corrcoef.py``)."""

import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import _confusion_matrix_update
from metrics_tpu_torch.utils.compute import _sqrt

_matthews_corrcoef_update = _confusion_matrix_update


def _matthews_corrcoef_compute(confmat: torch.Tensor) -> torch.Tensor:
    """float32 MCC from a ``(C, C)`` confusion matrix (0 where the denominator is 0)."""
    tk = confmat.sum(1).to(torch.float32)
    pk = confmat.sum(0).to(torch.float32)
    c = torch.trace(confmat).to(torch.float32)
    s = confmat.sum().to(torch.float32)

    cov_ytyp = c * s - (tk * pk).sum()
    cov_ypyp = s**2 - (pk * pk).sum()
    cov_ytyt = s**2 - (tk * tk).sum()

    denom = cov_ypyp * cov_ytyt
    zero = denom == 0
    return torch.where(zero, 0.0, cov_ytyp / _sqrt(torch.where(zero, 1.0, denom)))


def matthews_corrcoef(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    threshold: float = 0.5,
    validate_args: bool = True,
) -> torch.Tensor:
    """Matthews correlation coefficient, on the device of the inputs.

    Example:
        >>> import torch
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> round(float(matthews_corrcoef(preds, target, num_classes=2)), 6)
        0.57735
    """
    confmat = _matthews_corrcoef_update(preds, target, num_classes, threshold, validate_args=validate_args)
    return _matthews_corrcoef_compute(confmat)
