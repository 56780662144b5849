"""UniversalImageQualityIndex (counterpart of ``metrics_tpu/image/uqi.py``).

UQI's value is a mean over the per-pixel UQI map, which decomposes exactly
over batches, so only ``(sum, count)`` is kept, as in the JAX package.
"""

from typing import Any, Optional, Sequence

import torch

from metrics_tpu_torch.functional.image.uqi import _uqi_check_inputs, _uqi_map
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat

_VALID_REDUCTIONS = ("elementwise_mean", "sum", "none", None)


class UniversalImageQualityIndex(Metric):
    """UQI over a stream of image batches.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import UniversalImageQualityIndex
        >>> preds = torch.rand((16, 1, 16, 16), generator=torch.Generator().manual_seed(0))
        >>> metric = UniversalImageQualityIndex(device="cpu")
        >>> metric.update(preds, preds * 0.75)
        >>> float(metric.compute()) > 0.9
        True
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        reduction: Optional[str] = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if reduction not in _VALID_REDUCTIONS:
            raise ValueError("Reduction parameter unknown.")
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.reduction = reduction
        if reduction in ("none", None):
            self.add_state("score", default=[], dist_reduce_fx="cat")
        else:
            self.add_state("score_sum", default=torch.tensor(0.0), dist_reduce_fx="sum")
            self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target = _uqi_check_inputs(preds, target)
        uqi_map = _uqi_map(preds, target, self.kernel_size, self.sigma)
        if self.reduction in ("none", None):
            self.score.append(uqi_map)
        else:
            self.score_sum = self.score_sum + uqi_map.sum()
            self.total = self.total + uqi_map.numel()

    def compute(self) -> torch.Tensor:
        if self.reduction in ("none", None):
            return dim_zero_cat(self.score)
        if self.reduction == "sum":
            return self.score_sum
        return self.score_sum / self.total
