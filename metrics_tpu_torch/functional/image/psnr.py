"""peak_signal_noise_ratio (counterpart of ``metrics_tpu/functional/image/psnr.py``)."""

from typing import Optional, Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _as_tensor
from metrics_tpu_torch.utils.data import reduce
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _psnr_compute(
    sum_squared_error: torch.Tensor,
    n_obs: torch.Tensor,
    data_range: torch.Tensor,
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
) -> torch.Tensor:
    """PSNR from the accumulated squared error and observation count."""
    psnr_base_e = 2 * torch.log(data_range) - torch.log(sum_squared_error / n_obs)
    psnr_vals = psnr_base_e * (10 / torch.log(torch.tensor(base, dtype=torch.float32, device=psnr_base_e.device)))
    return reduce(psnr_vals, reduction=reduction)


def _psnr_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The float32 sum of squared errors and the int32 observation count (over ``dim``, or all)."""
    if dim is None:
        diff = preds - target
        return torch.sum(diff * diff), torch.full((), target.numel(), dtype=torch.int32, device=target.device)
    diff = preds - target
    dim_list = [dim] if isinstance(dim, int) else list(dim)
    if not dim_list:  # jnp.sum over no axes reduces nothing (torch.sum over none reduces all)
        return diff * diff, torch.full((), target.numel(), dtype=torch.int32, device=target.device)
    sum_squared_error = torch.sum(diff * diff, dim=dim_list)
    n = 1
    for d in dim_list:
        n *= target.shape[d]
    return sum_squared_error, torch.full(sum_squared_error.shape, n, dtype=torch.int32, device=target.device)


def peak_signal_noise_ratio(
    preds: torch.Tensor,
    target: torch.Tensor,
    data_range: Optional[float] = None,
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> torch.Tensor:
    """PSNR between two images, on the device of the inputs.

    Example:
        >>> import torch
        >>> pred = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> round(float(peak_signal_noise_ratio(pred, target)), 4)
        2.5527
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if dim is None and reduction != "elementwise_mean":
        rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")
    if data_range is None:
        if dim is not None:
            raise ValueError("The `data_range` must be given when `dim` is not None.")
        data_range = target.max() - target.min()
    else:
        data_range = torch.tensor(float(data_range), dtype=torch.float32, device=target.device)
    sum_squared_error, n_obs = _psnr_update(preds, target, dim=dim)
    return _psnr_compute(sum_squared_error, n_obs, data_range, base=base, reduction=reduction)
