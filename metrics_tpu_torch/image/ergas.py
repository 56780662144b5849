"""ErrorRelativeGlobalDimensionlessSynthesis (counterpart of ``metrics_tpu/image/ergas.py``).

Per-image ERGAS scores are computed in ``update``; only their sum and count
are kept, as in the JAX package.
"""

from typing import Any, Optional, Union

import torch

from metrics_tpu_torch.functional.image.ergas import _ergas_check_inputs, _ergas_per_image
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat

_VALID_REDUCTIONS = ("elementwise_mean", "sum", "none", None)


class ErrorRelativeGlobalDimensionlessSynthesis(Metric):
    """ERGAS over a stream of image batches.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ErrorRelativeGlobalDimensionlessSynthesis
        >>> preds = torch.rand((16, 1, 16, 16), generator=torch.Generator().manual_seed(42))
        >>> metric = ErrorRelativeGlobalDimensionlessSynthesis(device="cpu")
        >>> metric.update(preds, preds * 0.75)
        >>> float(metric.compute()) > 0
        True
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        ratio: Union[int, float] = 4,
        reduction: Optional[str] = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if reduction not in _VALID_REDUCTIONS:
            raise ValueError("Reduction parameter unknown.")
        self.ratio = ratio
        self.reduction = reduction
        if reduction in ("none", None):
            self.add_state("score", default=[], dist_reduce_fx="cat")
        else:
            self.add_state("score_sum", default=torch.tensor(0.0), dist_reduce_fx="sum")
            self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target = _ergas_check_inputs(preds, target)
        per_image = _ergas_per_image(preds, target, self.ratio)
        if self.reduction in ("none", None):
            self.score.append(per_image)
        else:
            self.score_sum = self.score_sum + per_image.sum()
            self.total = self.total + per_image.shape[0]

    def compute(self) -> torch.Tensor:
        if self.reduction in ("none", None):
            return dim_zero_cat(self.score)
        if self.reduction == "sum":
            return self.score_sum
        return self.score_sum / self.total
