"""MultioutputWrapper (counterpart of ``metrics_tpu/wrappers/multioutput.py``)."""

from copy import deepcopy
from typing import Any, List, Optional, Tuple

import torch

from metrics_tpu_torch.metric import Metric


def _get_nan_indices(*tensors: torch.Tensor) -> torch.Tensor:
    """Rows where any input carries a NaN."""
    if len(tensors) == 0:
        raise ValueError("Must pass at least one tensor as argument")
    nan_idxs = torch.zeros(tensors[0].shape[0], dtype=torch.bool, device=tensors[0].device)
    for tensor in tensors:
        flat = tensor.reshape(tensor.shape[0], -1).to(torch.float32)
        nan_idxs = nan_idxs | torch.isnan(flat).any(dim=-1)
    return nan_idxs


class MultioutputWrapper(Metric):
    """One copy of the base metric per output column; no aggregation across outputs.

    With ``remove_nans`` each output drops the rows where any of its inputs
    is NaN before its copy updates: one device->host read per output per
    update, as the rows kept decide the shapes.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanSquaredError, MultioutputWrapper
        >>> mo = MultioutputWrapper(MeanSquaredError(device="cpu"), num_outputs=2, device="cpu")
        >>> mo.update(torch.tensor([[0.0, 1.0], [2.0, 3.0]]), torch.tensor([[0.5, 1.0], [2.0, 2.0]]))
        >>> [round(float(v), 3) for v in mo.compute()]
        [0.125, 0.5]
    """

    is_differentiable = False
    full_state_update = True
    traced_update = False

    def __init__(
        self,
        base_metric: Metric,
        num_outputs: int,
        output_dim: int = -1,
        remove_nans: bool = True,
        squeeze_outputs: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if base_metric.device != self.device:
            raise ValueError(f"the base metric keeps its state on {base_metric.device}, the wrapper on {self.device}")
        self.metrics = [deepcopy(base_metric) for _ in range(num_outputs)]
        self.output_dim = output_dim
        self.remove_nans = remove_nans
        self.squeeze_outputs = squeeze_outputs
        self.sync_on_compute = False  # the copies sync their own states

    def _get_args_kwargs_by_output(self, *args: Any, **kwargs: Any) -> List[Tuple[list, dict]]:
        """Each output's inputs along ``output_dim``, without the rows that hold a NaN."""
        args = [torch.as_tensor(a, device=self.device) for a in args]
        kwargs = {k: torch.as_tensor(v, device=self.device) for k, v in kwargs.items()}
        out = []
        for i in range(len(self.metrics)):
            selected_args = [a.narrow(self.output_dim, i, 1) for a in args]
            selected_kwargs = {k: v.narrow(self.output_dim, i, 1) for k, v in kwargs.items()}
            if self.remove_nans:
                nan_idxs = _get_nan_indices(*selected_args, *selected_kwargs.values())
                keep = torch.nonzero(~nan_idxs).squeeze(1)  # the device->host read
                selected_args = [a.index_select(0, keep) for a in selected_args]
                selected_kwargs = {k: v.index_select(0, keep) for k, v in selected_kwargs.items()}
            if self.squeeze_outputs:
                selected_args = [a.squeeze(self.output_dim) for a in selected_args]
                selected_kwargs = {k: v.squeeze(self.output_dim) for k, v in selected_kwargs.items()}
            out.append((selected_args, selected_kwargs))
        return out

    def update(self, *args: Any, **kwargs: Any) -> None:
        for metric, (sel_args, sel_kwargs) in zip(self.metrics, self._get_args_kwargs_by_output(*args, **kwargs)):
            metric._update_wrapper(*sel_args, **sel_kwargs)

    def compute(self) -> List[torch.Tensor]:
        return [m._compute_wrapper() for m in self.metrics]

    def forward(self, *args: Any, **kwargs: Any) -> Optional[List[Any]]:
        """Each output's copy's own ``forward``."""
        results = [
            metric.forward(*sel_args, **sel_kwargs)
            for metric, (sel_args, sel_kwargs) in zip(self.metrics, self._get_args_kwargs_by_output(*args, **kwargs))
        ]
        if any(r is None for r in results):
            return None
        return results

    def reset(self) -> None:
        for m in self.metrics:
            m.reset()
        super().reset()
