"""Streaming quantile and histogram metrics over the KLL sketch
(counterpart of ``metrics_tpu/streaming/quantile.py``).

Bounded-state replacements for ``cat``-state percentile evaluation: the
state is a fixed ``(levels, capacity)`` sketch whatever the stream's length,
and a sync rides the ``"sketch"`` reduce: every rank gathers its peers'
sketches and folds them with :func:`~metrics_tpu_torch.streaming.kll_merge`,
so the synced estimate is as good as one sketch over the union of the shards.

A ``SketchMetric`` reports the compactions its sketch ran (the growth of
the sketch's ``nc`` leaf) under the ``streaming.sketch_compactions``
counter: one read of ``nc`` per update-count change, at a state read
(``compute``, ``forward``, ``sync``, ``state``) and never in an update.
"""

from typing import Any, Dict

import numpy as np
import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.obs import core as _obs
from metrics_tpu_torch.streaming._threefry import fma32
from metrics_tpu_torch.streaming.sketches import (
    DEFAULT_CAPACITY,
    DEFAULT_MAX_ITEMS,
    kll_cdf,
    kll_init,
    kll_merge,
    kll_quantile,
    kll_rank_error_bound,
    kll_total_weight,
    kll_update,
)
from metrics_tpu_torch.utils.data import _linspace_thresholds, _total_order_keys

__all__ = ["SketchMetric", "StreamingQuantile", "StreamingHistogram"]


class SketchMetric(Metric):
    """Base for metrics whose primary state is one KLL sketch named ``"sketch"``.

    Args:
        capacity: per-level sketch width (even, >= 8); error ~ O(1/capacity).
        seed: PRNG seed of the compaction coin flips (``jax.random.PRNGKey(seed)``).
        max_items: design stream length (sets the level count).
    """

    is_differentiable = False
    higher_is_better = None
    stackable = True  # fixed-shape sketch state; streams stack on the vmap path

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        seed: int = 0,
        max_items: int = DEFAULT_MAX_ITEMS,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.capacity = int(capacity)
        self.add_sketch_state(
            "sketch", kll_init(capacity=capacity, seed=seed, max_items=max_items, device=self.device), kll_merge
        )
        # the compaction count last reported, and the update count it was read at
        self._nc_seen = 0
        self._nc_count_mark = -1

    def update(self, values) -> None:
        self._store_sketch_tree("sketch", kll_update(self.sketch_tree("sketch"), values))

    @property
    def n_items(self) -> int:
        """Items folded in so far (a host read)."""
        return int(self.sketch_tree("sketch")["n"])

    def rank_error_bound(self) -> float:
        """Worst-case normalized rank error of the current estimates."""
        return kll_rank_error_bound(max(self.n_items, 1), self.capacity)

    def reset(self) -> None:
        super().reset()
        # re-arm the baseline: after a reset the update count climbs back
        # through old values, so a stale mark would gate off every read
        self._nc_seen = 0
        self._nc_count_mark = -1

    def _flush_host_buffers(self) -> None:
        super()._flush_host_buffers()
        self._report_sketch_compactions()

    def _report_sketch_compactions(self) -> None:
        # one device read per update-count change, not per state read
        if self._update_count == self._nc_count_mark:
            return
        self._nc_count_mark = self._update_count
        cur = int(self.sketch__sk_nc)
        if cur > self._nc_seen:
            _obs.counter_inc("streaming.sketch_compactions", cur - self._nc_seen, metric=type(self).__name__)
        # cur < seen means a reset or an unsync restored an older state
        self._nc_seen = cur


class StreamingQuantile(SketchMetric):
    """O(1)-state online quantile estimator.

    ``update(values)`` folds a batch; ``compute()`` returns the estimated
    ``q``-quantile(s) of everything seen, across all ranks when a process
    group is up (sketch merge on gather), within :meth:`rank_error_bound`
    normalized rank of exact.

    Args:
        q: quantile(s) in [0, 1]; scalar in, scalar out.
        capacity, seed, max_items: see :class:`SketchMetric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import StreamingQuantile
        >>> m = StreamingQuantile(q=0.5, capacity=64, device="cpu")
        >>> m.update(torch.arange(11.0))
        >>> float(m.compute())
        5.0
    """

    def __init__(self, q=0.5, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        qs = np.atleast_1d(np.asarray(q, np.float64))
        if qs.size == 0 or ((qs < 0.0) | (qs > 1.0)).any():
            raise ValueError(f"quantiles must lie in [0, 1], got {q!r}")
        self._scalar_q = np.ndim(q) == 0
        self.q = tuple(float(x) for x in qs)

    def compute(self):
        return self._stacked_compute(None)

    def _stacked_compute(self, state):
        """The estimates of the sketch in ``state`` (the live one when None), or of
        every sketch of a stacked ``(S, L, K)`` state at once:
        :class:`~metrics_tpu_torch.multistream.MultiStreamMetric`'s compute."""
        out = kll_quantile(self.sketch_tree("sketch", state), torch.tensor(self.q, dtype=torch.float32, device=self.device))
        return out[..., 0] if self._scalar_q else out


def _xla_extreme(x: torch.Tensor, largest: bool) -> torch.Tensor:
    """``jnp.max``/``jnp.min`` over the last axis of floats without NaN: ranked by IEEE totalOrder, which
    puts ``-0.0`` below ``+0.0`` as XLA's max and min do (``torch.amin`` takes either zero)."""
    keys = _total_order_keys(x)
    at = keys.argmax(-1, keepdim=True) if largest else keys.argmin(-1, keepdim=True)
    return x.gather(-1, at)[..., 0]  # a tensor index: no read of ``at`` to the host


class StreamingHistogram(SketchMetric):
    """Fixed-state streaming histogram: ``compute()`` returns ``{"edges": (bins+1,),
    "counts": (bins,)}`` over the observed [min, max] range.

    Counts are sketch estimates (CDF differences scaled by the total weight),
    accurate to the sketch's rank-error bound; the edges are exact (min and
    max ride ordinary ``min``/``max`` reduces).  Under
    :class:`~metrics_tpu_torch.multistream.MultiStreamMetric` the sketch and
    both extremes stack over the streams: an update takes every stream's
    ``(S, m)`` block in one batched fold, and ``compute()`` gives ``(S, bins+1)``
    edges and ``(S, bins)`` counts, each stream's what ``jax.vmap`` of the
    JAX package's update and compute gives.
    """

    def __init__(self, bins: int = 10, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if int(bins) < 1:
            raise ValueError(f"bins must be >= 1, got {bins}")
        self.bins = int(bins)
        self.add_state("minv", torch.tensor(float("inf")), dist_reduce_fx="min")
        self.add_state("maxv", torch.tensor(float("-inf")), dist_reduce_fx="max")

    def update(self, values) -> None:
        vals = torch.as_tensor(values, device=self.device).to(torch.float32)
        # a stacked state takes one row of values per stream; a single sketch one flat batch
        vals = vals.reshape(vals.shape[0], -1) if self.sketch_tree("sketch")["buf"].ndim == 3 else vals.reshape(-1)
        if vals.shape[-1] == 0:
            return
        super().update(vals)
        finite = torch.isfinite(vals)
        low = torch.where(finite, vals, torch.full_like(vals, float("inf")))
        high = torch.where(finite, vals, torch.full_like(vals, float("-inf")))
        self.minv = _xla_extreme(torch.cat([self.minv[..., None], low], -1), largest=False)
        self.maxv = _xla_extreme(torch.cat([self.maxv[..., None], high], -1), largest=True)

    def compute(self) -> Dict[str, Any]:
        return self._stacked_compute(None)

    def _stacked_compute(self, state) -> Dict[str, Any]:
        """The histogram of the sketch in ``state`` (the live one when None), or of every sketch of a stacked
        state at once (:class:`~metrics_tpu_torch.multistream.MultiStreamMetric`'s compute)."""
        tree = self.sketch_tree("sketch", state)
        lo = (self.minv if state is None else state["minv"]).to(torch.float32)[..., None]
        hi = (self.maxv if state is None else state["maxv"]).to(torch.float32)[..., None]
        # degenerate (single value or empty) ranges still need increasing edges
        hi = torch.where(hi > lo, hi, lo + 1.0)
        grid = torch.from_numpy(_linspace_thresholds(self.bins + 1)).to(self.device)
        # XLA fuses lo + (hi - lo) * grid into one multiply-add
        edges = fma32(hi - lo, grid, lo)
        total = kll_total_weight(tree)[..., None]
        below = kll_cdf(tree, edges[..., 1:])
        # the first bin's lower edge is inclusive (it IS the observed minimum);
        # XLA contracts each difference of neighbouring upper counts with the
        # product before it: below * total - upper[i - 1], rounded once
        upper = below * total
        previous = torch.cat([torch.zeros_like(upper[..., :1]), upper[..., :-1]], -1)
        counts = fma32(below, total, -previous)
        counts = torch.where(total > 0, counts, torch.zeros_like(counts))
        return {"edges": edges, "counts": counts}
