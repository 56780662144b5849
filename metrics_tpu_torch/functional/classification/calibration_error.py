"""Calibration error functional
(counterpart of ``metrics_tpu/functional/classification/calibration_error.py``).

The JAX package sums each bin as a float32 one-hot matmul, shaped for the
TPU's matrix unit.  Here each bin's sum is a ``torch.bincount`` with float64
weights, rounded once to float32: no TF32 matmul, and no float32 atomics
whose order changes from run to run.
"""

from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _as_tensor, _checked_inputs
from metrics_tpu_torch.utils.compute import _sqrt
from metrics_tpu_torch.utils.data import _linspace_thresholds
from metrics_tpu_torch.utils.enums import DataType


def _bin_edges(n_bins: int, device: torch.device) -> torch.Tensor:
    """float32 ``jnp.linspace(0, 1, n_bins + 1)``, bit for bit."""
    return torch.from_numpy(_linspace_thresholds(n_bins + 1)).to(device)


def _bin_indices(confidences: torch.Tensor, bin_boundaries: torch.Tensor) -> torch.Tensor:
    """Each confidence's bin: ``searchsorted(side="left") - 1``, clipped to ``[0, n_bins)``.
    A confidence on an edge falls in the bin below it, 0.0 in the first, a NaN in the last."""
    n_bins = bin_boundaries.numel() - 1
    indices = torch.searchsorted(bin_boundaries, confidences.contiguous(), right=False) - 1
    return indices.clamp(0, n_bins - 1)


def _binning_bucketize(
    confidences: torch.Tensor, accuracies: torch.Tensor, bin_boundaries: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-bin mean accuracy, mean confidence, and sample proportion (float32)."""
    n_bins = bin_boundaries.numel() - 1
    confidences, accuracies = confidences.reshape(-1), accuracies.reshape(-1)
    indices = _bin_indices(confidences, bin_boundaries)
    count_bin = torch.bincount(indices, minlength=n_bins).to(torch.float32)

    def bin_sums(values: torch.Tensor) -> torch.Tensor:
        return torch.bincount(indices, weights=values.to(torch.float64), minlength=n_bins).to(torch.float32)

    occupied, per = count_bin > 0, torch.clamp(count_bin, min=1)
    conf_bin = torch.where(occupied, bin_sums(confidences) / per, 0.0)
    acc_bin = torch.where(occupied, bin_sums(accuracies) / per, 0.0)
    prop_bin = count_bin / count_bin.sum()
    return acc_bin, conf_bin, prop_bin


def _ce_compute(
    confidences: torch.Tensor,
    accuracies: torch.Tensor,
    bin_boundaries: torch.Tensor,
    norm: str = "l1",
    debias: bool = False,
) -> torch.Tensor:
    if norm not in ("l1", "l2", "max"):
        raise ValueError(f"Norm {norm} is not supported. Please select from l1, l2, or max. ")
    acc_bin, conf_bin, prop_bin = _binning_bucketize(confidences, accuracies, bin_boundaries)
    if norm == "l1":
        return (torch.abs(acc_bin - conf_bin) * prop_bin).sum()
    if norm == "max":
        return torch.abs(acc_bin - conf_bin).max()
    ce = (torch.pow(acc_bin - conf_bin, 2) * prop_bin).sum()
    if debias:
        debias_bins = (acc_bin * (acc_bin - 1) * prop_bin) / (prop_bin * accuracies.numel() - 1)
        ce = ce + torch.nan_to_num(debias_bins).sum()
    return torch.where(ce > 0, _sqrt(torch.clamp(ce, min=0.0)), 0.0)


def _ce_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each sample's top-1 confidence and whether its top-1 class is right (float32).

    The top-1 choice is ``argmax``'s: the first NaN wins, then the first of tied
    maxima (not the total order ``select_topk`` ranks by)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    _, _, mode = _checked_inputs(preds, target, validate_args=False)

    if mode == DataType.BINARY:
        confidences, accuracies = preds, target
    elif mode == DataType.MULTICLASS:
        confidences = preds.amax(1)
        accuracies = preds.argmax(1) == target
    elif mode == DataType.MULTIDIM_MULTICLASS:
        flat = torch.movedim(preds, 1, -1).reshape(-1, preds.shape[1])
        confidences = flat.amax(1)
        accuracies = flat.argmax(1) == target.reshape(-1)
    else:
        raise ValueError(
            f"Calibration error is not well-defined for data with size {tuple(preds.shape)} "
            f"and targets {tuple(target.shape)}."
        )
    return confidences.to(torch.float32), accuracies.to(torch.float32)


def calibration_error(preds: torch.Tensor, target: torch.Tensor, n_bins: int = 15, norm: str = "l1") -> torch.Tensor:
    """Expected (``l1``), maximum (``max``) or RMS (``l2``) calibration error over equal-width
    confidence bins, on the device of the inputs.

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.25, 0.25, 0.55, 0.75, 0.75])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> round(float(calibration_error(preds, target, n_bins=2, norm='l1')), 6)
        0.29
    """
    if norm not in ("l1", "l2", "max"):
        raise ValueError(f"Argument `norm` is expected to be one of 'l1', 'l2', 'max' but got {norm}")
    if not isinstance(n_bins, int) or n_bins <= 0:
        raise ValueError(f"Expected argument `n_bins` to be a int larger than 0 but got {n_bins}")
    confidences, accuracies = _ce_update(preds, target)
    return _ce_compute(confidences, accuracies, _bin_edges(n_bins, confidences.device), norm=norm)
