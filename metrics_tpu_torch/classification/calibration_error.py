"""CalibrationError module metric (counterpart of ``metrics_tpu/classification/calibration_error.py``)."""

from typing import Any

import torch

from metrics_tpu_torch.functional.classification.calibration_error import _bin_edges, _ce_compute, _ce_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat


class CalibrationError(Metric):
    """Expected (``l1``), maximum (``max``) or RMS (``l2``) calibration error over
    ``n_bins`` equal-width confidence bins.

    Each sample's top-1 confidence and correctness are kept as list states
    (``confidences``, ``accuracies``), gathered with ``cat``, as in the JAX package.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CalibrationError
        >>> metric = CalibrationError(n_bins=2, device='cpu')
        >>> metric.update(torch.tensor([0.25, 0.25, 0.55, 0.75, 0.75]), torch.tensor([0, 0, 1, 1, 1]))
        >>> round(float(metric.compute()), 6)
        0.29
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(self, n_bins: int = 15, norm: str = "l1", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if norm not in ("l1", "l2", "max"):
            raise ValueError(f"Argument `norm` is expected to be one of 'l1', 'l2', 'max' but got {norm}")
        if not isinstance(n_bins, int) or n_bins <= 0:
            raise ValueError(f"Expected argument `n_bins` to be a int larger than 0 but got {n_bins}")
        self.n_bins = n_bins
        self.norm = norm
        self.bin_boundaries = _bin_edges(n_bins, self.device)
        self.add_state("confidences", [], dist_reduce_fx="cat")
        self.add_state("accuracies", [], dist_reduce_fx="cat")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        confidences, accuracies = _ce_update(preds, target)
        self.confidences.append(confidences)
        self.accuracies.append(accuracies)

    def compute(self) -> torch.Tensor:
        confidences = dim_zero_cat(self.confidences)
        accuracies = dim_zero_cat(self.accuracies)
        return _ce_compute(confidences, accuracies, self.bin_boundaries, norm=self.norm)
