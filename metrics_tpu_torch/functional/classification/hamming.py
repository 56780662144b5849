"""Hamming distance functional (counterpart of ``metrics_tpu/functional/classification/hamming.py``)."""

from typing import Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _input_format_classification


def _hamming_distance_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
    validate_args: bool = True,
) -> Tuple[torch.Tensor, int]:
    preds, target, _ = _input_format_classification(preds, target, threshold=threshold, validate_args=validate_args)
    correct = (preds == target).sum(dtype=torch.int32)
    return correct, preds.numel()


def _hamming_distance_compute(correct: torch.Tensor, total: Union[int, torch.Tensor]) -> torch.Tensor:
    return 1 - correct.to(torch.float32) / total


def hamming_distance(
    preds: torch.Tensor, target: torch.Tensor, threshold: float = 0.5, validate_args: bool = True
) -> torch.Tensor:
    """The share of labels predicted wrong, on the device of the inputs.

    Example:
        >>> import torch
        >>> target = torch.tensor([[0, 1], [1, 1]])
        >>> preds = torch.tensor([[0, 1], [0, 1]])
        >>> float(hamming_distance(preds, target))
        0.25
    """
    correct, total = _hamming_distance_update(preds, target, threshold, validate_args)
    return _hamming_distance_compute(correct, total)
