"""PeakSignalNoiseRatio (counterpart of ``metrics_tpu/image/psnr.py``)."""

from typing import Any, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.image.psnr import _psnr_compute, _psnr_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.checks import _as_tensor
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.prints import rank_zero_warn


class PeakSignalNoiseRatio(Metric):
    """PSNR over a stream of image batches.

    Args:
        data_range: value range of the images; if ``None`` it is tracked as a
            running (min, max) over all targets (requires ``dim=None``).
        base: logarithm base.
        reduction: ``'elementwise_mean' | 'sum' | 'none'`` (used with ``dim``).
        dim: dimensions to reduce over before averaging PSNR scores; ``None``
            pools the squared error globally (constant-memory state).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PeakSignalNoiseRatio
        >>> metric = PeakSignalNoiseRatio(device="cpu")
        >>> metric.update(torch.tensor([[0.0, 1.0], [2.0, 3.0]]), torch.tensor([[3.0, 2.0], [1.0, 0.0]]))
        >>> round(float(metric.compute()), 4)
        2.5527
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        data_range: Optional[float] = None,
        base: float = 10.0,
        reduction: Optional[str] = "elementwise_mean",
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if dim is None and reduction != "elementwise_mean":
            rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")

        if dim is None:
            self.add_state("sum_squared_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
            self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")
        else:
            self.add_state("sum_squared_error", default=[], dist_reduce_fx="cat")
            self.add_state("total", default=[], dist_reduce_fx="cat")

        if data_range is None:
            if dim is not None:
                raise ValueError("The `data_range` must be given when `dim` is not None.")
            # trackers start at 0.0 so the range always spans 0 (targets in [2, 4] give range 4)
            self.data_range = None
            self.add_state("min_target", default=torch.tensor(0.0), dist_reduce_fx="min")
            self.add_state("max_target", default=torch.tensor(0.0), dist_reduce_fx="max")
        else:
            self.add_state("data_range", default=torch.tensor(float(data_range)), dist_reduce_fx="mean")
        self.base = base
        self.reduction = reduction
        self.dim = tuple(dim) if isinstance(dim, Sequence) else dim

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target = _as_tensor(preds), _as_tensor(target)
        sum_squared_error, n_obs = _psnr_update(preds, target, dim=self.dim)
        if self.dim is None:
            if self.data_range is None:
                self.min_target = torch.minimum(target.min(), self.min_target)
                self.max_target = torch.maximum(target.max(), self.max_target)
            self.sum_squared_error = self.sum_squared_error + sum_squared_error
            self.total = self.total + n_obs
        else:
            self.sum_squared_error.append(sum_squared_error)
            self.total.append(n_obs)

    def compute(self) -> torch.Tensor:
        data_range = self.data_range if self.data_range is not None else self.max_target - self.min_target
        if self.dim is None:
            sum_squared_error = self.sum_squared_error
            total = self.total
        else:
            sum_squared_error = dim_zero_cat([v.reshape(-1) for v in self.sum_squared_error])
            total = dim_zero_cat([v.reshape(-1) for v in self.total])
        return _psnr_compute(sum_squared_error, total, data_range, base=self.base, reduction=self.reduction)
