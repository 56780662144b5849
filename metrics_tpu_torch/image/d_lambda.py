"""SpectralDistortionIndex (counterpart of ``metrics_tpu/image/d_lambda.py``).

The (C, C) cross-channel UQI matrices are accumulated as streaming sums
(their entries are means over the per-pixel UQI maps, which decompose
exactly over batches), as in the JAX package: constant O(C^2) memory.
"""

from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.image.d_lambda import _pairwise_uqi_means, _spectral_distortion_check_inputs
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import reduce


class SpectralDistortionIndex(Metric):
    """D_lambda over a stream of image batches.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SpectralDistortionIndex
        >>> preds = torch.rand((16, 3, 16, 16), generator=torch.Generator().manual_seed(0))
        >>> target = torch.rand((16, 3, 16, 16), generator=torch.Generator().manual_seed(1))
        >>> metric = SpectralDistortionIndex(device="cpu")
        >>> metric.update(preds, target)
        >>> float(metric.compute()) < 0.2
        True
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        p: int = 1,
        reduction: Optional[str] = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(p, int) or p <= 0:
            raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
        self.p = p
        if reduction not in ("elementwise_mean", "sum", "none", None):
            raise ValueError("Reduction parameter unknown.")
        self.reduction = reduction
        # running sums of the per-pair UQI means, weighted by sample count; the
        # scalar defaults widen to (C, C) at the first update
        self.add_state("m1_sum", default=torch.zeros(()), dist_reduce_fx="sum", widen_ndim=2)
        self.add_state("m2_sum", default=torch.zeros(()), dist_reduce_fx="sum", widen_ndim=2)
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target = _spectral_distortion_check_inputs(preds, target)
        n = preds.shape[0]
        self.m1_sum = self.m1_sum + _pairwise_uqi_means(target) * n
        self.m2_sum = self.m2_sum + _pairwise_uqi_means(preds) * n
        self.total = self.total + n

    def compute(self) -> torch.Tensor:
        m1 = self.m1_sum / self.total
        m2 = self.m2_sum / self.total
        length = m1.shape[0] if m1.ndim else 1
        diff = torch.abs(m1 - m2) ** self.p
        if length == 1:
            output = diff ** (1.0 / self.p)
        else:
            output = (torch.sum(diff) / (length * (length - 1))) ** (1.0 / self.p)
        return reduce(output, self.reduction)
