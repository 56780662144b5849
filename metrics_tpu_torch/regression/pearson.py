"""PearsonCorrCoef module metric (counterpart of ``metrics_tpu/regression/pearson.py``).

The six running statistics cannot be merged one by one (the variance merge
needs both means), so they sync by gather (``dist_reduce_fx=None``): one row
per rank.  ``compute`` folds the rows in rank order with the parallel-variance
rule, :func:`_final_aggregation`.
"""

from typing import Any, Tuple

import torch

from metrics_tpu_torch.functional.regression.pearson import _pearson_corrcoef_compute, _pearson_corrcoef_update
from metrics_tpu_torch.metric import Metric


def _final_aggregation(
    means_x: torch.Tensor,
    means_y: torch.Tensor,
    vars_x: torch.Tensor,
    vars_y: torch.Tensor,
    corrs_xy: torch.Tensor,
    nbs: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge per-rank (mean, var, cov) rows by Chan's parallel algorithm, in rank order."""
    mx1, my1, vx1, vy1, cxy1, n1 = means_x[0], means_y[0], vars_x[0], vars_y[0], corrs_xy[0], nbs[0]
    for i in range(1, means_x.shape[0]):
        mx2, my2, vx2, vy2, cxy2, n2 = means_x[i], means_y[i], vars_x[i], vars_y[i], corrs_xy[i], nbs[i]
        nb = n1 + n2
        mean_x = (n1 * mx1 + n2 * mx2) / nb
        mean_y = (n1 * my1 + n2 * my2) / nb
        delta_x1, delta_x2 = mx1 - mean_x, mx2 - mean_x
        delta_y1, delta_y2 = my1 - mean_y, my2 - mean_y
        var_x = vx1 + vx2 + n1 * delta_x1 * delta_x1 + n2 * delta_x2 * delta_x2
        var_y = vy1 + vy2 + n1 * delta_y1 * delta_y1 + n2 * delta_y2 * delta_y2
        corr_xy = cxy1 + cxy2 + n1 * delta_x1 * delta_y1 + n2 * delta_x2 * delta_y2
        mx1, my1, vx1, vy1, cxy1, n1 = mean_x, mean_y, var_x, var_y, corr_xy, nb
    return vx1, vy1, cxy1, n1


class PearsonCorrCoef(Metric):
    """Pearson correlation over the stream: six ``(1,)`` float32 states.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PearsonCorrCoef
        >>> metric = PearsonCorrCoef(device='cpu')
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(metric.compute()), 6)
        0.98487
    """

    is_differentiable = True
    higher_is_better = None
    full_state_update = True
    stackable = True  # fixed-shape Welford accumulators; streams stack independently

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        zero = torch.zeros((1,), dtype=torch.float32)
        for name in ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total"):
            self.add_state(name, default=zero, dist_reduce_fx=None)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total = _pearson_corrcoef_update(
            preds, target, self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total
        )

    def compute(self) -> torch.Tensor:
        if self.mean_x.shape[0] > 1:  # synced: one row per rank
            var_x, var_y, corr_xy, n_total = _final_aggregation(
                self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total
            )
        else:
            var_x, var_y, corr_xy, n_total = self.var_x, self.var_y, self.corr_xy, self.n_total
        return _pearson_corrcoef_compute(var_x, var_y, corr_xy, n_total)
