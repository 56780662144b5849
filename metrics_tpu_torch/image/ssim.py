"""StructuralSimilarityIndexMeasure / MultiScaleStructuralSimilarityIndexMeasure
(counterpart of ``metrics_tpu/image/ssim.py``).

As in the JAX package, per-image scores are computed in ``update`` and only
``(score_sum, total)`` is kept; with ``reduction='none'`` the per-image
scores (not the images) are stored.  With ``data_range=None`` the range is
taken per batch: pass an explicit ``data_range`` for results independent of
the stream's order.
"""

from typing import Any, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.image.ssim import (
    _msssim_combine,
    _multiscale_ssim_stacks,
    _ssim_check_inputs,
    _ssim_per_image,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat

_VALID_REDUCTIONS = ("elementwise_mean", "sum", "none", None)


class StructuralSimilarityIndexMeasure(Metric):
    """SSIM over a stream of image batches (constant-memory state).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import StructuralSimilarityIndexMeasure
        >>> preds = torch.rand((4, 3, 32, 32), generator=torch.Generator().manual_seed(0))
        >>> metric = StructuralSimilarityIndexMeasure(data_range=1.0, device="cpu")
        >>> metric.update(preds, preds * 0.75)
        >>> float(metric.compute()) > 0.9
        True
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        gaussian_kernel: bool = True,
        sigma: Union[float, Sequence[float]] = 1.5,
        kernel_size: Union[int, Sequence[int]] = 11,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[float] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if reduction not in _VALID_REDUCTIONS:
            raise ValueError("Reduction parameter unknown.")
        self.gaussian_kernel = gaussian_kernel
        self.sigma = sigma
        self.kernel_size = kernel_size
        self.reduction = reduction
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        if reduction in ("none", None):
            self.add_state("score", default=[], dist_reduce_fx="cat")
        else:
            self.add_state("score_sum", default=torch.tensor(0.0), dist_reduce_fx="sum")
            self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target = _ssim_check_inputs(preds, target)
        per_image = _ssim_per_image(
            preds, target, self.gaussian_kernel, self.sigma, self.kernel_size, self.data_range, self.k1, self.k2,
        )
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


class MultiScaleStructuralSimilarityIndexMeasure(Metric):
    """MS-SSIM over a stream of image batches.

    The per-scale (sim, cs) batch sums, the exact sufficient statistics of
    the per-scale batch reduction, are accumulated, O(S) memory;
    ``reduction='none'`` keeps per-image per-scale values.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MultiScaleStructuralSimilarityIndexMeasure
        >>> preds = torch.rand((1, 1, 256, 256), generator=torch.Generator().manual_seed(42))
        >>> metric = MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, device="cpu")
        >>> metric.update(preds, preds * 0.75)
        >>> float(metric.compute()) > 0.9
        True
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        gaussian_kernel: bool = True,
        kernel_size: Union[int, Sequence[int]] = 11,
        sigma: Union[float, Sequence[float]] = 1.5,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[float] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
        normalize: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if reduction not in _VALID_REDUCTIONS:
            raise ValueError("Reduction parameter unknown.")
        if not isinstance(betas, tuple):
            raise ValueError("Argument `betas` is expected to be of a type tuple.")
        if not all(isinstance(beta, float) for beta in betas):
            raise ValueError("Argument `betas` is expected to be a tuple of floats.")
        if normalize and normalize not in ("relu", "simple"):
            raise ValueError("Argument `normalize` to be expected either `None` or one of 'relu' or 'simple'")
        self.gaussian_kernel = gaussian_kernel
        self.sigma = sigma
        self.kernel_size = kernel_size
        self.reduction = reduction
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.betas = betas
        self.normalize = normalize
        n_scales = len(betas)
        if reduction in ("none", None):
            self.add_state("sim_stack", default=[], dist_reduce_fx="cat")
            self.add_state("cs_stack", default=[], dist_reduce_fx="cat")
        else:
            self.add_state("sim_sum", default=torch.zeros(n_scales), dist_reduce_fx="sum")
            self.add_state("cs_sum", default=torch.zeros(n_scales), dist_reduce_fx="sum")
            self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target = _ssim_check_inputs(preds, target)
        sim, cs = _multiscale_ssim_stacks(
            preds, target, self.gaussian_kernel, self.sigma, self.kernel_size,
            self.data_range, self.k1, self.k2, self.betas,
        )  # (S, B)
        if self.reduction in ("none", None):
            self.sim_stack.append(sim.T)  # cat over the image axis
            self.cs_stack.append(cs.T)
        else:
            self.sim_sum = self.sim_sum + sim.sum(dim=1)
            self.cs_sum = self.cs_sum + cs.sum(dim=1)
            self.total = self.total + sim.shape[1]

    def compute(self) -> torch.Tensor:
        if self.reduction in ("none", None):
            sim = dim_zero_cat(self.sim_stack).T  # (S, N)
            cs = dim_zero_cat(self.cs_stack).T
            return _msssim_combine(sim, cs, self.betas, "none", self.normalize)
        if self.reduction == "sum":
            sim, cs = self.sim_sum, self.cs_sum
        else:
            sim, cs = self.sim_sum / self.total, self.cs_sum / self.total
        # already reduced over the batch axis; combine scales only
        return _msssim_combine(sim[:, None], cs[:, None], self.betas, "none", self.normalize)[0]
