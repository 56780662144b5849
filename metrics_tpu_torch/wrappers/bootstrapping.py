"""BootStrapper (counterpart of ``metrics_tpu/wrappers/bootstrapping.py``).

``num_bootstraps`` copies of the base metric; every update feeds each copy a
with-replacement resample of the batch along dim 0.  The resample indices
come from ``np.random.default_rng(seed)`` on the host, drawn as the JAX
package draws them, so both packages resample alike from the same seed.

The JAX package draws in one of two ways, and the port picks the same one by
the same facts.  A base whose update the JAX package traces (no buffer state,
no list state, ``traced_update``) is updated there as one stacked state under
``vmap``: ``multinomial`` draws ``(copies, size)`` indices, and ``poisson``
draws each copy's total ``N ~ Poisson(size)`` (capped) and then a
``(copies, cap)`` index matrix, of which copy ``i`` takes the first ``N_i``
rows.  Any other base is updated copy by copy: ``multinomial`` draws the same
matrix, ``poisson`` draws per-row ``Poisson(1)`` counts for every copy.

Here the copies are updated in a loop on the device: the indices of a batch
go to the device in one upload, and each copy gathers its rows from them.  A
copy that drew no rows is not updated, and a copy that never drew any stays
out of the statistics.
"""

import numbers
from copy import deepcopy
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.wrappers._resample import bootstrap_resample_indices, stacked_poisson_draws


def _take_rows(args: tuple, kwargs: dict, rows: torch.Tensor, size: int):
    """Every batch-shaped tensor argument at ``rows``; other arguments pass unchanged."""
    def take(x: Any) -> Any:
        if isinstance(x, torch.Tensor) and x.ndim >= 1 and x.shape[0] == size:
            return x.index_select(0, rows)
        return x

    return [take(a) for a in args], {k: take(v) for k, v in kwargs.items()}


class BootStrapper(Metric):
    """Bootstrap confidence statistics over a base metric.

    ``compute`` returns a dict of the copies' ``mean``, ``std`` (``ddof=1``),
    ``quantile`` (linear interpolation) and ``raw`` values, as asked for.
    ``reset`` re-seeds the generator.  The copies sync their own states when
    ``compute`` runs under a process group; the wrapper holds none.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import BootStrapper, MeanSquaredError
        >>> b = BootStrapper(MeanSquaredError(device="cpu"), num_bootstraps=20,
        ...                  sampling_strategy="multinomial", seed=0, device="cpu")
        >>> b.update(torch.arange(16.0), torch.arange(16.0) + 0.5)
        >>> out = b.compute()
        >>> sorted(out), round(float(out["mean"]), 2)
        (['mean', 'std'], 0.25)
    """

    full_state_update = True
    traced_update = False

    def __init__(
        self,
        base_metric: Metric,
        num_bootstraps: int = 10,
        mean: bool = True,
        std: bool = True,
        quantile: Optional[Union[float, Sequence[float]]] = None,
        raw: bool = False,
        sampling_strategy: str = "poisson",
        seed: int = 0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of metrics_tpu_torch.Metric but received {base_metric}"
            )
        if base_metric.device != self.device:
            raise ValueError(f"the base metric keeps its state on {base_metric.device}, the wrapper on {self.device}")
        allowed_sampling = ("poisson", "multinomial")
        if sampling_strategy not in allowed_sampling:
            raise ValueError(
                f"Expected argument ``sampling_strategy`` to be one of {allowed_sampling}"
                f" but received {sampling_strategy}"
            )
        self.metrics = [deepcopy(base_metric) for _ in range(num_bootstraps)]
        self.num_bootstraps = num_bootstraps
        self.mean = mean
        self.std = std
        self.quantile = quantile
        self.raw = raw
        self.sampling_strategy = sampling_strategy
        self.seed = seed
        self.sync_on_compute = False  # the copies sync their own states
        self._rng = np.random.default_rng(seed)
        # whether the JAX package stacks this base (fixed by the first update) and
        # whether the copies' input case is locked on a whole batch yet
        self._stacked: Optional[bool] = None
        self._locked = False
        # rows each stacked poisson copy has taken: a copy that took none stays out
        self._replica_rows: Optional[np.ndarray] = None

    @staticmethod
    def _batch_size(args: tuple, kwargs: dict) -> int:
        for x in (*args, *kwargs.values()):
            if isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim >= 1:
                return int(x.shape[0])
        raise ValueError("None of the input contained tensors, so could not determine the sampling size")

    def _stackable(self, args: tuple, kwargs: dict) -> bool:
        """The facts by which the JAX package updates the copies as one stacked state."""
        base = self.metrics[0]
        plain_inputs = all(
            x is None or isinstance(x, (torch.Tensor, np.ndarray, numbers.Number))
            for x in (*args, *kwargs.values())
        )
        has_list = any(isinstance(d, list) for d in base._defaults.values())
        return base.traced_update and not base._buffer_states and not has_list and plain_inputs

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Feed each copy a resampled batch."""
        size = self._batch_size(args, kwargs)
        if size == 0:
            return  # every resample of an empty batch is empty
        if self._stacked is None:
            self._stacked = self._stackable(args, kwargs)
        if self._stacked:
            self._update_stacked(args, kwargs, size)
        else:
            self._update_copies(args, kwargs, size)

    def _update_stacked(self, args: tuple, kwargs: dict, size: int) -> None:
        """The JAX package's stacked draws; each copy takes its rows in one update.

        The input case locks on the whole batch, as the JAX package locks it
        before its traced update: the first copy on every batch, the others
        on the first.
        """
        self.metrics[0]._pre_update(*args, **kwargs)
        if not self._locked:
            for m in self.metrics[1:]:
                m._pre_update(*args, **kwargs)
            self._locked = True
        reps = self.num_bootstraps
        if self.sampling_strategy == "multinomial":
            idx = self._rng.integers(0, size, size=(reps, size))
            counts = np.full(reps, size, np.int32)
        else:
            counts, idx = stacked_poisson_draws(self._rng, size, reps)
            if self._replica_rows is None:
                self._replica_rows = np.zeros(reps, np.int64)
            self._replica_rows += counts
        idx = torch.from_numpy(idx).to(self.device)
        for i, m in enumerate(self.metrics):
            if counts[i]:
                sel_args, sel_kwargs = _take_rows(args, kwargs, idx[i, : int(counts[i])], size)
                m._computed = None
                m._update_impl(*sel_args, **sel_kwargs)
            fed = self._replica_rows is None or self._replica_rows[i] > 0
            m._update_count = self._update_count if fed else 0

    def _update_copies(self, args: tuple, kwargs: dict, size: int) -> None:
        """Per-copy draws, as the JAX package draws them for a base it does not stack."""
        draws = bootstrap_resample_indices(self._rng, size, self.num_bootstraps, self.sampling_strategy)
        lengths = [len(d) for d in draws]
        flat = torch.from_numpy(np.concatenate(list(draws))).to(self.device)
        start = 0
        for m, n in zip(self.metrics, lengths):
            if n:  # an empty poisson resample would poison the copy with NaN
                sel_args, sel_kwargs = _take_rows(args, kwargs, flat[start : start + n], size)
                m._update_wrapper(*sel_args, **sel_kwargs)
            start += n

    def compute(self) -> Dict[str, torch.Tensor]:
        """Mean/std/quantile/raw over the copies that took rows (all of them when none did)."""
        active = [m for m in self.metrics if m._update_count > 0] or self.metrics
        values = torch.stack([torch.as_tensor(m._compute_wrapper()) for m in active], dim=0)
        output: Dict[str, torch.Tensor] = {}
        if self.mean:
            output["mean"] = values.sum(0) / torch.full((), values.shape[0], dtype=values.dtype, device=values.device)
        if self.std:
            output["std"] = torch.std(values, dim=0, correction=1)
        if self.quantile is not None:
            q = torch.as_tensor(self.quantile, dtype=values.dtype, device=values.device)
            output["quantile"] = torch.quantile(values, q, dim=0)
        if self.raw:
            output["raw"] = values
        return output

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, torch.Tensor]:
        """Accumulate the batch and return the running statistics."""
        self._update_wrapper(*args, **kwargs)
        return self._compute_wrapper()

    def reset(self) -> None:
        for m in self.metrics:
            m.reset()
        self._rng = np.random.default_rng(self.seed)
        self._stacked = None
        self._locked = False
        self._replica_rows = None
        super().reset()
