"""Windowed and time-decayed wrappers: recent-history evaluation with fixed-shape state
(counterpart of ``metrics_tpu/streaming/window.py``).

``WindowedMetric`` keeps a ring of per-bucket states: every base-metric state
is stored with a leading ``(window_size,)`` bucket axis, a write pointer on
the device picks the live bucket, and :meth:`~WindowedMetric.advance` rotates
the ring, resetting one bucket in place of reallocating.  ``update`` reads
and writes the live bucket with index operations on the device pointer: no
device-to-host read.

``TimeDecayedMetric`` is the O(1) alternative when bucket boundaries do not
matter: an exponential moving average of per-update compute values with a
configurable half-life.
"""

from typing import Any, Dict, List

import numpy as np
import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.obs import core as _obs
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

__all__ = ["WindowedMetric", "TimeDecayedMetric"]

_WINDOW_FXS = ("sum", "mean", "max", "min")


class _VmappedMerge:
    """Slot-wise sketch merge for ring buffers of sketches (the JAX package vmaps the base merge).

    A base merge that takes batched states (``batched_merge``, as
    :func:`~metrics_tpu_torch.streaming.kll_merge` does) folds every slot in
    one call (one kernel launch on CUDA); any other merges slot by slot.  A
    module-level class, not a closure, so windowed metrics pickle.
    """

    def __init__(self, merge_fn, batched_merge: bool = False):
        self.merge_fn = merge_fn
        self.batched_merge = batched_merge

    def __call__(self, trees):
        trees = list(trees)
        if len(trees) == 1:
            return dict(trees[0])
        if self.batched_merge:
            return self.merge_fn(trees)
        slots = next(iter(trees[0].values())).shape[0]
        per_slot = [self.merge_fn([{k: v[i] for k, v in t.items()} for t in trees]) for i in range(slots)]
        return {k: torch.stack([s[k] for s in per_slot]) for k in per_slot[0]}


def _reduce_identity(fx: str, like: torch.Tensor) -> torch.Tensor:
    dtype = like.dtype
    if fx in ("sum", "mean"):
        return torch.zeros((), dtype=dtype, device=like.device)
    if dtype.is_floating_point:
        return torch.tensor(float("-inf") if fx == "max" else float("inf"), dtype=dtype, device=like.device)
    info = torch.iinfo(dtype)
    return torch.tensor(info.min if fx == "max" else info.max, dtype=dtype, device=like.device)


def _as_int32(t: torch.Tensor) -> torch.Tensor:
    """A uint32 key ring as int32 words (index operations do not take uint32)."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def _ring_read(ring: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """``ring[ptr]`` for a device pointer, without reading it to the host."""
    return _as_int32(ring).index_select(0, ptr.reshape(1).long())[0].view(ring.dtype)


def _ring_write(ring: torch.Tensor, ptr: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """A copy of ``ring`` with ``ring[ptr] = value``, without reading the pointer to the host."""
    out = _as_int32(ring).index_copy(0, ptr.reshape(1).long(), _as_int32(value.to(ring.dtype))[None])
    return out.view(ring.dtype)


class WindowedMetric(Metric):
    """Evaluate ``metric`` over a sliding window of the last ``window_size`` buckets.

    Updates land in the current bucket; :meth:`advance` rotates to the next
    (evicting what it held a full window ago); :meth:`compute` merges the
    active buckets (elementwise for ``sum``/``mean``/``max``/``min`` states,
    sketch merge for sketch states) and runs the base metric's ``compute`` on
    the merged state.

    The base metric needs fixed-shape tensor states with ``dist_reduce_fx``
    in ``("sum", "mean", "max", "min")`` and/or sketch states: no list or
    buffer states, whose per-bucket shapes would grow with the data.  A sync
    reduces bucket for bucket (rank ``r``'s bucket ``i`` with every other
    rank's bucket ``i``), which assumes the ranks advance in lockstep.  Like
    the other wrappers it takes no device from its base: pass the same
    ``device=`` to both.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SumMetric, WindowedMetric
        >>> w = WindowedMetric(SumMetric(device="cpu"), window_size=2, device="cpu")
        >>> w.update(torch.tensor(1.0)); _ = w.advance(); w.update(torch.tensor(2.0))
        >>> _ = w.advance(); w.update(torch.tensor(4.0))
        >>> float(w.compute())
        6.0
    """

    full_state_update = True

    def __init__(self, metric: Metric, window_size: int, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(metric, Metric):
            raise MetricsTPUUserError(f"WindowedMetric expects a Metric instance, got {type(metric).__name__}")
        if metric.device != self.device:
            raise ValueError(f"the base metric keeps its state on {metric.device}, the wrapper on {self.device}")
        if int(window_size) < 1:
            raise MetricsTPUUserError(f"window_size must be >= 1, got {window_size}")
        if metric._buffer_states or any(isinstance(d, list) for d in metric._defaults.values()):
            raise MetricsTPUUserError(
                "WindowedMetric requires fixed-shape base states; list/buffer "
                "states grow with the stream — use a sketch-state metric "
                "(e.g. StreamingQuantile) for unbounded inputs"
            )
        sketch_leaves = metric._sketch_leaf_key_set()
        for name, fx in metric._reduce_fns.items():
            if name not in sketch_leaves and fx not in _WINDOW_FXS:
                raise MetricsTPUUserError(
                    f"WindowedMetric cannot window state {name!r} with "
                    f"dist_reduce_fx {fx!r}; bucket merges need one of "
                    f"{_WINDOW_FXS} or a sketch state"
                )
        self._base = metric
        self.window_size = w = int(window_size)

        def stack_default(value: torch.Tensor) -> torch.Tensor:
            return value[None].expand((w,) + tuple(value.shape)).clone()

        # sketch states ride the same ring: the stacked leaves form a
        # (window,)-leading tree, and the per-bucket sync merge is the base
        # merge over the bucket axis; "wb_" + sketch leaf key == "wb_" + base key
        for sname, smeta in metric._sketch_states.items():
            stacked = {leaf: stack_default(metric._defaults[f"{sname}__sk_{leaf}"]) for leaf in smeta["leaves"]}
            batched = bool(getattr(smeta["merge"], "batched_merge", False))
            self.add_sketch_state("wb_" + sname, stacked, _VmappedMerge(smeta["merge"], batched))
        for name, default in metric._defaults.items():
            if name not in sketch_leaves:
                self.add_state("wb_" + name, stack_default(default), dist_reduce_fx=metric._reduce_fns[name])
        self.add_state("w__ptr", torch.zeros((), dtype=torch.int32), dist_reduce_fx="max")
        self.add_state("w__count", torch.zeros((w,), dtype=torch.int32), dist_reduce_fx="sum")
        self._base_keys: List[str] = list(metric._defaults)

    def _pre_update(self, *args: Any, **kwargs: Any) -> None:
        self._base._pre_update(*args, **kwargs)

    def update(self, *args: Any, **kwargs: Any) -> None:
        ptr = self.w__ptr
        slot = {k: _ring_read(getattr(self, "wb_" + k), ptr) for k in self._base_keys}
        new_slot = self._base.apply_update(slot, *args, **kwargs)
        for k in self._base_keys:
            setattr(self, "wb_" + k, _ring_write(getattr(self, "wb_" + k), ptr, new_slot[k]))
        self.w__count = _ring_write(self.w__count, ptr, _ring_read(self.w__count, ptr) + 1)

    def advance(self) -> int:
        """Rotate to the next bucket, evicting what it held.

        Host-side: reads the pointer and the incoming bucket's update count,
        resets that bucket to the base defaults (same shapes) and moves the
        pointer.  Returns the number of updates the evicted bucket held.
        A placed window rotates each rank's own ring.
        """
        w = self.window_size
        new_ptr = (int(self.w__ptr) + 1) % w
        evicted = int(self.w__count[new_ptr])
        if evicted > 0:
            _obs.counter_inc("streaming.window_evictions", metric=type(self._base).__name__)
        for k in self._base_keys:
            ring = getattr(self, "wb_" + k).clone()
            _as_int32(ring)[new_ptr] = _as_int32(self._base._defaults[k])
            setattr(self, "wb_" + k, ring)
        count = self.w__count.clone()
        count[new_ptr] = 0
        self.w__count = count
        self.w__ptr = torch.tensor(new_ptr, dtype=torch.int32, device=self.device)
        self._computed = None
        return evicted

    def window_counts(self) -> np.ndarray:
        """Per-bucket update counts (host-side; the current bucket last)."""
        counts = self.w__count.cpu().numpy()
        return np.roll(counts, -int(self.w__ptr) - 1)

    def compute(self):
        counts = self.w__count
        active = counts > 0
        total = torch.clamp(counts.sum(dtype=torch.int32), min=1)
        merged: Dict[str, Any] = {}
        for sname, smeta in self._base._sketch_states.items():
            rings = {leaf: getattr(self, f"wb_{sname}__sk_{leaf}") for leaf in smeta["leaves"]}
            slot_trees = [{leaf: ring[i] for leaf, ring in rings.items()} for i in range(self.window_size)]
            # empty (default) sketches are merge identities: inactive buckets fold in harmlessly
            tree = smeta["merge"](slot_trees) if len(slot_trees) > 1 else slot_trees[0]
            merged.update({f"{sname}__sk_{leaf}": tree[leaf] for leaf in smeta["leaves"]})
        for k in self._base_keys:
            if k in merged:
                continue
            fx = self._base._reduce_fns[k]
            stacked = getattr(self, "wb_" + k)
            mask = active.reshape((self.window_size,) + (1,) * (stacked.ndim - 1))
            ident = _reduce_identity(fx, stacked)
            if fx == "sum":
                merged[k] = torch.where(mask, stacked, ident).sum(0, dtype=stacked.dtype)
            elif fx == "mean":
                wts = counts.to(stacked.dtype).reshape(mask.shape)
                merged[k] = (stacked * wts).sum(0) / total.to(stacked.dtype)
            elif fx == "max":
                merged[k] = torch.where(mask, stacked, ident).amax(0)
            else:
                merged[k] = torch.where(mask, stacked, ident).amin(0)
        return self._base.apply_compute(merged)


class TimeDecayedMetric(Metric):
    """Exponentially time-decayed view of ``metric``: each ``update`` batch
    contributes its own compute value, and older batches decay with the
    configured half-life (in updates).

    ``compute`` returns the EMA ``sum(d**age * value) / sum(d**age)`` with
    ``d = 0.5 ** (1 / half_life)``: O(1) state, no buckets.  The base metric
    must produce a numeric (tensor) compute value.
    """

    full_state_update = True

    def __init__(self, metric: Metric, half_life: float = 100.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(metric, Metric):
            raise MetricsTPUUserError(f"TimeDecayedMetric expects a Metric instance, got {type(metric).__name__}")
        if metric.device != self.device:
            raise ValueError(f"the base metric keeps its state on {metric.device}, the wrapper on {self.device}")
        if not float(half_life) > 0:
            raise MetricsTPUUserError(f"half_life must be > 0, got {half_life}")
        self._base = metric
        self.half_life = float(half_life)
        self.decay = 0.5 ** (1.0 / self.half_life)
        # the 0-d states take the value's shape at the first update
        self.add_state("ema_num", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum", widen_ndim=None)
        self.add_state("ema_den", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def _pre_update(self, *args: Any, **kwargs: Any) -> None:
        self._base._pre_update(*args, **kwargs)

    def update(self, *args: Any, **kwargs: Any) -> None:
        fresh = self._base.apply_update(self._base.init_state(), *args, **kwargs)
        value = torch.as_tensor(self._base.apply_compute(fresh), dtype=torch.float32, device=self.device)
        d = torch.tensor(self.decay, dtype=torch.float32, device=self.device)
        self.ema_num = self.ema_num * d + value
        self.ema_den = self.ema_den * d + 1.0

    def compute(self):
        floor = torch.tensor(1e-12, dtype=torch.float32, device=self.device)
        return self.ema_num / torch.maximum(self.ema_den, floor)
