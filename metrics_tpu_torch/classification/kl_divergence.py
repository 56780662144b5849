"""KLDivergence module metric (counterpart of ``metrics_tpu/classification/kl_divergence.py``)."""

from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.classification.kl_divergence import _kld_compute, _kld_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat


class KLDivergence(Metric):
    """KL(P||Q) over the stream.  With ``reduction`` ``"mean"`` or ``"sum"`` the
    state is a float32 sum; with ``"none"``/``None`` it is a list of each row's
    divergence, gathered with ``cat``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import KLDivergence
        >>> metric = KLDivergence(device='cpu')
        >>> metric.update(torch.tensor([[0.36, 0.48, 0.16]]), torch.tensor([[1/3, 1/3, 1/3]]))
        >>> round(float(metric.compute()), 6)
        0.0853
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    stackable = False  # non-probabilistic mode holds a growing list state

    def __init__(self, log_prob: bool = False, reduction: Optional[str] = "mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(log_prob, bool):
            raise TypeError(f"Expected argument `log_prob` to be bool but got {log_prob}")
        allowed_reduction = ("mean", "sum", "none", None)
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.log_prob = log_prob
        self.reduction = reduction
        if reduction in ("mean", "sum"):
            self.add_state("measures", torch.tensor(0.0), dist_reduce_fx="sum")
        else:
            self.add_state("measures", [], dist_reduce_fx="cat")
        self.add_state("total", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, p: torch.Tensor, q: torch.Tensor) -> None:
        measures, total = _kld_update(p, q, self.log_prob)
        if self.reduction in ("none", None):
            self.measures.append(measures)
        else:
            self.measures = self.measures + measures.sum()
        self.total = self.total + total

    def compute(self) -> torch.Tensor:
        measures = dim_zero_cat(self.measures) if self.reduction in ("none", None) else self.measures
        return _kld_compute(measures, self.total, self.reduction)
