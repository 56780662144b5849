"""R2Score module metric (counterpart of ``metrics_tpu/regression/r2.py``)."""

from typing import Any

import torch

from metrics_tpu_torch.functional.regression.r2 import _r2_score_compute, _r2_score_update
from metrics_tpu_torch.metric import Metric


class R2Score(Metric):
    """R² over the stream: three float32 sums per output (``(num_outputs,)``,
    or scalars for one output, which a 2-D batch widens to its width) and an
    int32 row count.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import R2Score
        >>> metric = R2Score(device='cpu')
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(metric.compute()), 6)
        0.948608
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    stackable = True  # fixed (num_outputs,) sum states; per-stream stacking is exact

    def __init__(
        self,
        num_outputs: int = 1,
        adjusted: int = 0,
        multioutput: str = "uniform_average",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_outputs = num_outputs
        if adjusted < 0 or not isinstance(adjusted, int):
            raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
        self.adjusted = adjusted
        allowed_multioutput = ("raw_values", "uniform_average", "variance_weighted")
        if multioutput not in allowed_multioutput:
            raise ValueError(
                f"Invalid input to argument `multioutput`. Choose one of the following: {allowed_multioutput}"
            )
        self.multioutput = multioutput
        shape = (num_outputs,) if num_outputs > 1 else ()
        widen = 0 if num_outputs > 1 else 1
        for name in ("sum_squared_error", "sum_error", "residual"):
            self.add_state(name, default=torch.zeros(shape), dist_reduce_fx="sum", widen_ndim=widen)
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        sum_squared_obs, sum_obs, rss, n_obs = _r2_score_update(preds, target)
        self.sum_squared_error = self.sum_squared_error + sum_squared_obs
        self.sum_error = self.sum_error + sum_obs
        self.residual = self.residual + rss
        self.total = self.total + n_obs

    def compute(self) -> torch.Tensor:
        return _r2_score_compute(
            self.sum_squared_error, self.sum_error, self.residual, self.total, self.adjusted, self.multioutput
        )
