"""SpectralAngleMapper (counterpart of ``metrics_tpu/image/sam.py``).

The per-pixel angle map is reduced to (sum, count) in ``update``, as in the
JAX package.
"""

from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.image.sam import _sam_check_inputs, _sam_map
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat

_VALID_REDUCTIONS = ("elementwise_mean", "sum", "none", None)


class SpectralAngleMapper(Metric):
    """SAM over a stream of image batches.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SpectralAngleMapper
        >>> preds = torch.rand((16, 3, 16, 16), generator=torch.Generator().manual_seed(42))
        >>> target = torch.rand((16, 3, 16, 16), generator=torch.Generator().manual_seed(123))
        >>> metric = SpectralAngleMapper(device="cpu")
        >>> metric.update(preds, target)
        >>> 0 < float(metric.compute()) < 1.6
        True
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if reduction not in _VALID_REDUCTIONS:
            raise ValueError("Reduction parameter unknown.")
        self.reduction = reduction
        if reduction in ("none", None):
            self.add_state("score", default=[], dist_reduce_fx="cat")
        else:
            self.add_state("score_sum", default=torch.tensor(0.0), dist_reduce_fx="sum")
            self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target = _sam_check_inputs(preds, target)
        sam_map = _sam_map(preds, target)
        if self.reduction in ("none", None):
            self.score.append(sam_map)
        else:
            self.score_sum = self.score_sum + sam_map.sum()
            self.total = self.total + sam_map.numel()

    def compute(self) -> torch.Tensor:
        if self.reduction in ("none", None):
            return dim_zero_cat(self.score)
        if self.reduction == "sum":
            return self.score_sum
        return self.score_sum / self.total
