"""Tweedie deviance score (counterpart of ``metrics_tpu/functional/regression/tweedie_deviance.py``).

The JAX package checks the domain on a host copy of the batch; here each
check is one reduction on the device of the inputs and one read of its flag.
"""

from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _as_tensor, _check_same_shape
from metrics_tpu_torch.utils.compute import _count, _safe_xlogy


def _validate_tweedie_inputs(preds: torch.Tensor, targets: torch.Tensor, power: float) -> None:
    """The domain of ``power``'s deviance (a NaN breaks no rule, as in numpy)."""
    if power == 1 or 1 < power < 2:
        if bool(((preds <= 0) | (targets < 0)).any()):
            raise ValueError(
                f"For power={power}, 'preds' has to be strictly positive and 'targets' cannot be negative."
            )
    elif power < 0:
        if bool((preds <= 0).any()):
            raise ValueError(f"For power={power}, 'preds' has to be strictly positive.")
    elif power >= 2:
        if bool(((preds <= 0) | (targets <= 0)).any()):
            raise ValueError(f"For power={power}, both 'preds' and 'targets' have to be strictly positive.")


def _tweedie_deviance_score_update(
    preds: torch.Tensor, targets: torch.Tensor, power: float = 0.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 sum of the deviances and their int32 count."""
    preds, targets = _as_tensor(preds), _as_tensor(targets)
    _check_same_shape(preds, targets)
    if 0 < power < 1:
        raise ValueError(f"Deviance Score is not defined for power={power}.")
    _validate_tweedie_inputs(preds, targets, power)
    preds, targets = preds.to(torch.float32), targets.to(torch.float32)

    def const(c: float) -> torch.Tensor:  # a divisor on the device: see utils.compute._mean
        return torch.full((), c, dtype=torch.float32, device=preds.device)

    if power == 0:
        deviance_score = torch.square(targets - preds)
    elif power == 1:  # Poisson
        deviance_score = 2 * (_safe_xlogy(targets, targets / preds) + preds - targets)
    elif power == 2:  # Gamma
        deviance_score = 2 * (torch.log(preds / targets) + targets / preds - 1)
    else:
        term_1 = torch.pow(targets.clamp_min(0.0), 2 - power) / const((1 - power) * (2 - power))
        term_2 = targets * torch.pow(preds, 1 - power) / const(1 - power)
        term_3 = torch.pow(preds, 2 - power) / const(2 - power)
        deviance_score = 2 * (term_1 - term_2 + term_3)
    return deviance_score.sum(), _count(deviance_score.numel(), preds.device)


def _tweedie_deviance_score_compute(sum_deviance_score: torch.Tensor, num_observations: torch.Tensor) -> torch.Tensor:
    return sum_deviance_score / num_observations


def tweedie_deviance_score(preds: torch.Tensor, targets: torch.Tensor, power: float = 0.0) -> torch.Tensor:
    """Mean Tweedie deviance for the given power (0=Normal, 1=Poisson, 2=Gamma), on the device of the inputs.

    Example:
        >>> import torch
        >>> targets = torch.tensor([1.0, 2.0, 3.0, 4.0])
        >>> preds = torch.tensor([4.0, 3.0, 2.0, 1.0])
        >>> float(tweedie_deviance_score(preds, targets, power=0))
        5.0
    """
    sum_deviance_score, num_observations = _tweedie_deviance_score_update(preds, targets, power)
    return _tweedie_deviance_score_compute(sum_deviance_score, num_observations)
