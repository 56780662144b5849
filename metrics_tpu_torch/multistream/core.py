"""One Metric, S independent streams backed by stacked state tensors
(counterpart of ``metrics_tpu/multistream/core.py``).

:class:`MultiStreamMetric` wraps a supported base metric and re-registers
every base state with a leading ``(num_streams, ...)`` axis (via
:meth:`Metric.stacked_states`).  ``update(..., stream_ids=...)`` routes each
input row to its stream without a Python loop over streams or rows, and
``compute()`` evaluates every stream at once.  Two update strategies, picked
at construction:

* **segment**: every base state is a fixed-shape tensor with a
  ``sum``/``max``/``min`` reduce and the base declares
  ``full_state_update = False``.  Each row's own update (from the default
  state) is added into its stream: ``sum`` states with ``index_add_`` for
  integers and a stable sort by stream plus ``torch.segment_reduce`` for
  floats (a fixed order on every device, the JAX package's row order on the
  CPU), ``max``/``min`` states with ``scatter_reduce`` from the reduce's
  identity.  A base may give the per-stream sums itself
  (``Metric._stream_update``): the StatScores family counts every row into
  its stream in one launch of the per-stream stat-scores kernel.  Any other
  base runs its update once per row under ``torch.func.vmap``; with
  ``Metric._rows_mapped`` set, value checks that read the host are skipped
  there, as they are under a JAX trace.
* **vmap**: the base holds sketch states (``StreamingQuantile``,
  ``StreamingHistogram``; the histogram's min and max stack beside).  Rows are
  bucketed by stream id into a ``(num_streams, max_rows_per_stream)`` block
  padded with NaN (sketch updates drop non-finite values) and the base's
  update folds every stream's block into its sketch in one call: one
  ``kll_fold`` over the S stacked sketches.

Because the stacked states are ordinary ``sum``/``max``/``min``/sketch
states, cross-process sync (the packed blob included), ``merge_state``
folds, ``state_dict``, pickling and the checkpoint codec all apply per axis
unchanged; stacked sketches merge slot-wise in one ``kll_merge``.

The query path (``compute_streams`` / ``top_k`` / ``bottom_k`` / ``where``)
ranks streams on the device and returns ``k`` rows.  The JAX package's
observability counters (``multistream.*``), its compiled query-program cache
and its mesh placement (``_state_spec``) have no counterpart here.
"""

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from metrics_tpu_torch.metric import Metric, _flatten_batched_inputs
from metrics_tpu_torch.obs import core as _obs
from metrics_tpu_torch.utils.data import _total_order_keys
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

__all__ = ["MultiStreamMetric"]

_SEGMENT_REDUCES = ("sum", "max", "min")


class _VmappedSketchMerge:
    """Slot-wise merge for a stacked sketch state: the base merge over the
    leading stream axis.  A merge that takes stacked states itself
    (``kll_merge.batched_merge``) folds all streams in one call; any other runs
    under ``torch.func.vmap``.  A module-level class, so pickled metrics can
    rebuild it."""

    def __init__(self, base_merge: Callable):
        self.base_merge = base_merge

    def __call__(self, trees: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        if getattr(self.base_merge, "batched_merge", False):
            return self.base_merge(list(trees))
        return torch.func.vmap(lambda *per_stream: self.base_merge(list(per_stream)))(*trees)

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, _VmappedSketchMerge) and self.base_merge == other.base_merge

    def __hash__(self) -> int:
        return hash((type(self).__name__, self.base_merge))


def _slot_counts(slot: torch.Tensor, num_streams: int) -> torch.Tensor:
    """Rows per slot, ``(num_streams + 1,)`` int32 (``torch.bincount`` on a CUDA tensor
    reads its maximum to the host first; this reads nothing)."""
    ones = torch.ones_like(slot, dtype=torch.int32)
    return torch.zeros(num_streams + 1, dtype=torch.int32, device=slot.device).index_add_(0, slot, ones)


def _segment_sum(rows: torch.Tensor, slot: torch.Tensor, num_streams: int, live: torch.Tensor, fold_in_order: bool) -> torch.Tensor:
    """``live + jax.ops.segment_sum(rows, slot, num_streams)``: rows whose slot is ``num_streams`` are dropped.

    Integers add with ``index_add_`` (exact in any order).  Floats add in a
    fixed order on the CPU and the GPU alike (atomic adds would not): a
    stable sort by slot, then ``torch.segment_reduce``.  With
    ``fold_in_order`` each stream's rows fold into its live value one by
    one, as XLA fuses ``live + segment_sum`` inside the JAX package's jitted
    update; without it (a base whose update the JAX package does not jit)
    the rows sum first and the sum adds to the live value.
    """
    if not rows.is_floating_point():
        shape = (num_streams + 1,) + tuple(rows.shape[1:])
        seg = torch.zeros(shape, dtype=rows.dtype, device=rows.device).index_add_(0, slot, rows)
        return live + seg[:num_streams].to(live.dtype)
    rows = rows.to(live.dtype)
    if fold_in_order:
        # each stream's live value first, then its rows in row order
        rows = torch.cat([live, rows])
        slot = torch.cat([torch.arange(num_streams, device=slot.device), slot])
    order = torch.sort(slot, stable=True).indices
    lengths = _slot_counts(slot, num_streams)
    summed = torch.segment_reduce(rows[order], "sum", lengths=lengths, axis=0, unsafe=True, initial=0)[:num_streams]
    return summed if fold_in_order else live + summed


def _segment_extreme(rows: torch.Tensor, slot: torch.Tensor, num_streams: int, fx: str) -> torch.Tensor:
    """``jax.ops.segment_max``/``segment_min``: a stream without rows holds the reduce's
    identity (-inf/+inf, or the integer type's extreme); a NaN row propagates."""
    shape = (num_streams + 1,) + tuple(rows.shape[1:])
    if rows.is_floating_point():
        identity = float("-inf") if fx == "max" else float("inf")
    else:
        info = torch.iinfo(rows.dtype)
        identity = info.min if fx == "max" else info.max
    index = slot.reshape((-1,) + (1,) * (rows.ndim - 1)).expand(rows.shape)
    out = torch.full(shape, identity, dtype=rows.dtype, device=rows.device)
    return out.scatter_reduce_(0, index, rows, "amax" if fx == "max" else "amin", include_self=True)[:num_streams]


class MultiStreamMetric(Metric):
    """Vectorize a base metric over ``num_streams`` independent streams.

    ``update(*args, stream_ids=..., **kwargs)`` takes the base metric's
    update arguments, every tensor carrying a leading row axis, plus an
    integer ``stream_ids`` vector assigning each row to a stream.  Rows with
    ids outside ``[0, num_streams)`` are dropped (counted in the
    ``stream_dropped`` state).  ``update(..., num_valid=k)`` declares rows
    past index ``k`` padding: they neither route nor count as dropped
    (``k`` a Python int or a one-element integer tensor).  ``compute()``
    returns the base metric's value per stream, stacked on a leading
    ``(num_streams, ...)`` axis; a stream that never received a row computes
    what the base yields on its default state (typically NaN).

    Args:
        base: a fresh (never-updated) metric instance on the same device.
            Its states must all be fixed-shape tensor states with
            ``sum``/``max``/``min`` reduces, or sketch states; ``sum`` states
            must default to zero (the identity the cross-rank sum sync
            assumes too).
        num_streams: the stream count S.
        max_rows_per_stream: per-stream row capacity of one update on the
            vmap (sketch) path; rows past it are dropped and counted.
            Defaults to ``min(batch, max(8, ceil(4 * batch / num_streams)))``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy
        >>> from metrics_tpu_torch.multistream import MultiStreamMetric
        >>> m = MultiStreamMetric(Accuracy(num_classes=2, device="cpu"), num_streams=3, device="cpu")
        >>> m.update(torch.tensor([1, 0, 1, 1]), torch.tensor([1, 1, 1, 0]),
        ...          stream_ids=torch.tensor([0, 0, 2, 2]))
        >>> [round(float(x), 2) for x in m.compute()[torch.tensor([0, 2])]]
        [0.5, 0.5]
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    # reserved (non-base) stacked bookkeeping states
    _ROWS_STATE = "stream_rows"
    _DROPPED_STATE = "stream_dropped"

    def __init__(
        self,
        base: Metric,
        num_streams: int,
        max_rows_per_stream: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(base, Metric):
            raise MetricsTPUUserError(f"MultiStreamMetric wraps a Metric instance, got {type(base).__name__}")
        if base.update_count or base._is_synced:
            raise MetricsTPUUserError(
                "MultiStreamMetric needs a fresh base metric: the wrapper owns all "
                "state, and updates already folded into the base cannot be split "
                "back into streams"
            )
        if isinstance(base, MultiStreamMetric):
            raise MetricsTPUUserError("MultiStreamMetric cannot nest another MultiStreamMetric")
        if base.stackable is False:
            raise MetricsTPUUserError(
                f"{type(base).__name__} declares stackable=False: its growing "
                "list/buffer state has no fixed-shape per-stream stacked form; "
                "wrap a stackable metric (tensor/sketch states) instead"
            )
        if base.device != self.device:
            raise MetricsTPUUserError(
                f"the base metric keeps its state on {base.device}, the MultiStreamMetric on {self.device}"
            )
        self.num_streams = int(num_streams)
        if self.num_streams < 1:
            raise ValueError(f"num_streams must be >= 1, got {num_streams}")
        # streams already counted under multistream.streams_active (read at a query)
        self._active_reported = 0
        self.max_rows_per_stream = None if max_rows_per_stream is None else int(max_rows_per_stream)
        if self.max_rows_per_stream is not None and self.max_rows_per_stream < 1:
            raise ValueError(f"max_rows_per_stream must be >= 1, got {max_rows_per_stream}")
        self._base = base
        # the base's update now only runs per row or per stream (no host reads of the values)
        base._rows_mapped = True

        specs = base.stacked_states(self.num_streams)  # rejects list/buffer states
        self._base_tensor_reduces: Dict[str, str] = {}
        self._base_sketch_names: List[str] = []
        for spec in specs:
            if spec["name"] in (self._ROWS_STATE, self._DROPPED_STATE):
                raise MetricsTPUUserError(
                    f"base state name {spec['name']!r} collides with MultiStreamMetric bookkeeping states"
                )
            if spec["kind"] == "sketch":
                self.add_sketch_state(spec["name"], spec["tree"], _VmappedSketchMerge(spec["merge"]))
                self._base_sketch_names.append(spec["name"])
                continue
            fx = spec["reduce"]
            if fx not in _SEGMENT_REDUCES:
                raise MetricsTPUUserError(
                    f"base state {spec['name']!r} reduces with {fx!r}; MultiStreamMetric "
                    f"supports tensor states with reduce in {_SEGMENT_REDUCES} and sketch "
                    "states"
                )
            if fx == "sum" and bool(spec["default"].any()):
                raise MetricsTPUUserError(
                    f"sum state {spec['name']!r} has a non-zero default; per-stream "
                    "scatter (like the cross-rank sum sync) needs the zero identity"
                )
            self.add_state(spec["name"], spec["default"], dist_reduce_fx=fx)
            self._base_tensor_reduces[spec["name"]] = fx

        if self._base_sketch_names:
            # the base's own update takes the stacked (S, m) block; its compute must read stacked states too
            if getattr(base, "_stacked_compute", None) is None:
                raise MetricsTPUUserError(
                    f"{type(base).__name__} holds sketch states but has no compute over stacked ones "
                    "(_stacked_compute), so MultiStreamMetric cannot evaluate its streams"
                )
            self._strategy = "vmap"
        else:
            if base.full_state_update is not False:
                raise MetricsTPUUserError(
                    "MultiStreamMetric's segment path needs full_state_update=False on "
                    f"the base ({type(base).__name__} declares "
                    f"{base.full_state_update!r}): per-row updates must be independent "
                    "of accumulated state to fold as a segment reduction"
                )
            self._strategy = "segment"

        # every flat base state key, in base registration order
        self._base_state_keys: List[str] = list(base._defaults.keys())
        self.add_state(self._ROWS_STATE, torch.zeros((self.num_streams,), dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state(self._DROPPED_STATE, torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    # ------------------------------------------------------------------ update
    def _check_update_inputs(self, stream_ids: Any, args: tuple, kwargs: dict) -> Tuple[torch.Tensor, list, Callable, List[bool], int]:
        """Shared update validation, run in :meth:`_pre_update` (before the base's
        own checks) and again inside :meth:`update` (shapes and dtypes only)."""
        if stream_ids is None:
            raise MetricsTPUUserError(
                "MultiStreamMetric.update needs stream_ids= assigning each input row to a stream"
            )
        ids = torch.as_tensor(stream_ids, device=self.device).reshape(-1)
        if ids.is_floating_point() or ids.is_complex() or ids.dtype == torch.bool:
            raise MetricsTPUUserError(f"stream_ids must be integers, got dtype {ids.dtype}")
        leaves, rebuild, is_batched, n, ragged = _flatten_batched_inputs(args, kwargs)
        if n is None:
            raise MetricsTPUUserError("MultiStreamMetric.update needs array inputs with a leading row axis")
        if ragged or n != ids.shape[0]:
            raise MetricsTPUUserError(
                "every array input must carry the same leading row axis as stream_ids "
                f"(got stream_ids of length {ids.shape[0]})"
            )
        if self._strategy == "vmap":
            for leaf, b in zip(leaves, is_batched):
                if b and not torch.as_tensor(leaf).is_floating_point():
                    raise MetricsTPUUserError(
                        "the vmapped (sketch) multistream path pads per-stream rows "
                        f"with NaN, which needs floating inputs; got dtype {leaf.dtype}"
                    )
        return ids.to(torch.int64), leaves, rebuild, is_batched, n

    def _pre_update(self, *args: Any, **kwargs: Any) -> None:
        kwargs = dict(kwargs)
        stream_ids = kwargs.pop("stream_ids", None)
        self._check_num_valid(kwargs.pop("num_valid", None))
        self._check_update_inputs(stream_ids, args, kwargs)
        # input-case locking and value checks run on the base, once, on the whole batch
        self._base._pre_update(*args, **kwargs)
        _obs.counter_inc("multistream.scatter_updates", metric=type(self._base).__name__)

    def _check_num_valid(self, num_valid: Any) -> Optional[torch.Tensor]:
        """Validation of the ``num_valid`` row count (shape and dtype only)."""
        if num_valid is None:
            return None
        nv = torch.as_tensor(num_valid, device=self.device).reshape(-1)
        if nv.is_floating_point() or nv.dtype == torch.bool:
            raise MetricsTPUUserError(f"num_valid must be an integer row count, got dtype {nv.dtype}")
        if nv.numel() != 1:
            raise MetricsTPUUserError(f"num_valid must be a single row count, got shape {tuple(nv.shape)}")
        return nv[0].to(torch.int64)

    def update(self, *args: Any, stream_ids: Any = None, num_valid: Any = None, **kwargs: Any) -> None:
        ids, leaves, rebuild, is_batched, n = self._check_update_inputs(stream_ids, args, kwargs)
        if n == 0:
            return
        S = self.num_streams
        valid = (ids >= 0) & (ids < S)
        nv = self._check_num_valid(num_valid)
        n_real: Any = n
        if nv is not None:
            # rows past num_valid are padding: they never route AND never count as dropped
            n_real = torch.clamp(nv, 0, n)
            valid = valid & (torch.arange(n, device=self.device) < n_real)
        # rows that do not route go to segment S, which every scatter drops
        slot = torch.where(valid, ids, torch.full_like(ids, S))
        leaves = [torch.as_tensor(x, device=self.device) if b else x for x, b in zip(leaves, is_batched)]
        if self._strategy == "segment":
            counts = self._segment_update(slot, leaves, rebuild, is_batched, n)
        else:
            counts = self._vmap_update(slot, leaves, rebuild, is_batched, n)
        self.stream_rows = self.stream_rows + counts
        self.stream_dropped = self.stream_dropped + (n_real - counts.sum()).to(torch.int32)

    def _per_row_states(self, leaves: list, rebuild: Callable, is_batched: List[bool], n: int) -> Dict[str, torch.Tensor]:
        """Each row's own update from the default state, stacked: ``torch.func.vmap``
        of the base's pure update over the rows (each a ``(1, ...)`` batch)."""
        default_state = self._base.init_state()
        batched_at = [i for i, b in enumerate(is_batched) if b]

        def one_row(*row_leaves: torch.Tensor) -> Dict[str, Any]:
            full = list(leaves)
            for i, leaf in zip(batched_at, row_leaves):
                full[i] = leaf
            a, kw = rebuild(full)
            return self._base.apply_update(dict(default_state), *a, **kw)

        # rows keep a leading axis of 1 so the base sees ordinary (1, ...) batches
        lifted = [leaves[i].reshape((n, 1) + tuple(leaves[i].shape[1:])) for i in batched_at]
        return torch.func.vmap(one_row)(*lifted)

    def _segment_update(self, slot: torch.Tensor, leaves: list, rebuild: Callable, is_batched: List[bool], n: int) -> torch.Tensor:
        S = self.num_streams
        a, kw = rebuild(leaves)
        sums = self._base._stream_update(slot, S, *a, **kw)
        per_row = self._per_row_states(leaves, rebuild, is_batched, n) if sums is None else None
        for name, fx in self._base_tensor_reduces.items():
            live = getattr(self, name)
            if per_row is None:
                if name in sums:  # else the base's rows add nothing to this state
                    setattr(self, name, live + sums[name].to(live.dtype))
            elif fx == "sum":
                # zero default (checked at construction): each row's state IS its contribution
                setattr(self, name, _segment_sum(per_row[name], slot, S, live, self._base.traced_update))
            else:
                seg = _segment_extreme(per_row[name], slot, S, fx).to(live.dtype)
                setattr(self, name, torch.maximum(live, seg) if fx == "max" else torch.minimum(live, seg))
        return _slot_counts(slot, S)[:S]

    def _rows_capacity(self, n: int) -> int:
        if self.max_rows_per_stream is not None:
            return min(self.max_rows_per_stream, n)
        return min(n, max(8, -(-4 * n // self.num_streams)))

    def _vmap_update(self, slot: torch.Tensor, leaves: list, rebuild: Callable, is_batched: List[bool], n: int) -> torch.Tensor:
        S = self.num_streams
        m = self._rows_capacity(n)
        # bucket rows by stream: a stable sort by id, each row's place its rank within its id
        order = torch.sort(slot, stable=True).indices
        sorted_ids = slot[order]
        pos = torch.arange(n, device=self.device) - torch.searchsorted(sorted_ids, sorted_ids, side="left")
        keep = (sorted_ids < S) & (pos < m)
        # overflow and invalid rows land in row S, which is cut off
        row_ids = torch.where(keep, sorted_ids, torch.full_like(sorted_ids, S))
        place = torch.clamp(pos, max=m - 1)
        staged = list(leaves)
        for i, b in enumerate(is_batched):
            if b:
                leaf = leaves[i]
                stage = torch.full((S + 1, m) + tuple(leaf.shape[1:]), float("nan"), dtype=leaf.dtype, device=self.device)
                stage[row_ids, place] = leaf[order]
                staged[i] = stage[:S]
        a, kw = rebuild(staged)
        # the base's update takes every stream's block at once (a batched sketch fold)
        lane_state = self._lane_state()
        new_state = self._base.apply_update(lane_state, *a, **kw)
        for k in self._base_state_keys:
            setattr(self, k, new_state[k])
        return _slot_counts(row_ids, S)[:S]

    # ----------------------------------------------------------------- compute
    def _lane_state(self, state: Optional[Dict[str, Any]] = None, ids: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """The base's stacked states (from ``state`` or the live metric), rows ``ids`` only when given."""
        out = {}
        for k in self._base_state_keys:
            value = getattr(self, k) if state is None else state[k]
            out[k] = value if ids is None else value[ids]
        return out

    def _stacked_compute(self, lane_state: Dict[str, Any]) -> Any:
        """Every stream's value from stacked states: the base's own stacked compute
        where it has one (a sketch's estimates read every stream at once), else
        ``torch.func.vmap`` of its pure compute over the stream axis."""
        stacked = getattr(self._base, "_stacked_compute", None)
        if stacked is not None:
            return stacked(lane_state)
        return torch.func.vmap(self._base.apply_compute)(lane_state)

    def compute(self) -> Any:
        """Every stream's value, stacked on a leading ``(num_streams, ...)`` axis (on the device)."""
        return self._stacked_compute(self._lane_state())

    # -------------------------------------------------------------- query path
    def _with_query_state(self, fn: Callable[[Optional[Dict[str, Any]]], Any]) -> Any:
        """Run ``fn`` against the queryable state, synced across ranks for the
        duration of the query when ``sync_on_compute`` asks for it (then
        unsynced, as ``compute`` is).  The tensors ``fn`` derives stay valid."""
        if self._is_synced or not self.sync_on_compute:
            return fn(None)
        with self.sync_context(should_sync=True):
            return fn(None)

    def _report_active(self) -> None:
        """Count the streams that got their first row since the last query
        under ``multistream.streams_active`` (one device read, at a query)."""
        active = int(torch.count_nonzero(getattr(self, self._ROWS_STATE)))
        if active > self._active_reported:
            _obs.counter_inc(
                "multistream.streams_active", active - self._active_reported, metric=type(self._base).__name__
            )
            self._active_reported = active

    def compute_streams(self, stream_ids: Any) -> Any:
        """Base values for just the given streams: gathers ``len(stream_ids)`` state rows on
        the device and computes only those, O(k) not O(S)."""
        ids = torch.as_tensor(stream_ids, device=self.device).reshape(-1).to(torch.int64)

        def query(state: Any) -> Any:
            values = self._stacked_compute(self._lane_state(state, ids))
            self._report_active()
            return values

        return self._with_query_state(query)

    def _stream_scores(self, key: Any) -> torch.Tensor:
        values = self._stacked_compute(self._lane_state())
        if key is not None:
            if isinstance(values, dict):
                values = values[key]
            elif isinstance(key, int):
                # a component index into the per-stream value, not the stream axis
                values = torch.as_tensor(values)[..., key]
            else:
                values = getattr(values, key)
        values = torch.as_tensor(values)
        if values.ndim != 1:
            raise MetricsTPUUserError(
                f"stream ranking needs one scalar per stream; compute gives shape "
                f"{tuple(values.shape)}: pass key= to select a scalar component"
            )
        return values

    def top_k(self, k: int, key: Any = None, largest: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """The ``k`` highest-valued streams as ``(values, stream_ids)`` device tensors of shape
        ``(k,)`` (int32 ids), ranked as ``lax.top_k`` ranks: float32 scores in IEEE
        totalOrder, ties to the lower stream id.

        ``key`` selects a scalar component when the base compute returns a
        dict (by key) or a vector (by index).  NaN scores (typically untouched
        streams) always rank last.
        """
        k = int(k)
        if not 1 <= k <= self.num_streams:
            raise ValueError(f"k must be in [1, {self.num_streams}], got {k}")
        _obs.counter_inc("multistream.topk_queries", metric=type(self._base).__name__)

        def query(_: Any) -> Tuple[torch.Tensor, torch.Tensor]:
            values = self._stream_scores(key)
            self._report_active()
            fill = float("-inf") if largest else float("inf")
            score = torch.where(torch.isnan(values), torch.full_like(values, fill), values).to(torch.float32)
            if not largest:
                score = -score
            idx = torch.sort(_total_order_keys(score), descending=True, stable=True).indices[:k]
            return values[idx], idx.to(torch.int32)

        return self._with_query_state(query)

    def bottom_k(self, k: int, key: Any = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The ``k`` lowest-valued streams as ``(values, stream_ids)``: see :meth:`top_k`."""
        return self.top_k(k, key=key, largest=False)

    def where(self, pred: Callable[[torch.Tensor], torch.Tensor], k: int, key: Any = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Up to ``k`` stream ids whose value satisfies ``pred`` (an elementwise
        predicate over the per-stream value vector), plus the total match count.

        Returns ``(ids, total)``: ``ids`` is a ``(k,)`` int32 device vector
        holding the lowest-numbered matching streams first, padded with
        ``-1``; ``total`` a scalar with the full match count (which may exceed
        ``k``).  A NaN value never matches.
        """
        k = int(k)
        if not 1 <= k <= self.num_streams:
            raise ValueError(f"k must be in [1, {self.num_streams}], got {k}")
        _obs.counter_inc("multistream.topk_queries", metric=type(self._base).__name__)

        def query(_: Any) -> Tuple[torch.Tensor, torch.Tensor]:
            self._report_active()
            values = self._stream_scores(key)
            mask = torch.as_tensor(pred(values)).to(torch.bool)
            if mask.shape != values.shape:
                raise MetricsTPUUserError(
                    f"where() predicate must be elementwise; got shape {tuple(mask.shape)} "
                    f"for values of shape {tuple(values.shape)}"
                )
            mask = mask & ~torch.isnan(values)
            total = mask.sum(dtype=torch.int32)
            streams = torch.arange(self.num_streams, device=values.device)
            first = torch.sort(torch.where(mask, streams, torch.full_like(streams, self.num_streams))).values[:k]
            return torch.where(first < self.num_streams, first, torch.full_like(first, -1)).to(torch.int32), total

        return self._with_query_state(query)

    def active_streams(self) -> int:
        """How many streams have received at least one row (a host int)."""
        return int(torch.count_nonzero(self.stream_rows))

    def dropped_rows(self) -> int:
        """Rows dropped so far: out-of-range ids, plus overflow past
        ``max_rows_per_stream`` on the vmap path (a host int)."""
        return int(self.stream_dropped)

    # -------------------------------------------------------- span migration
    def stream_slice(self, lo: int, hi: int) -> Dict[str, torch.Tensor]:
        """Host (CPU) copies of rows ``[lo, hi)`` of every stacked state leaf.

        Every ``(num_streams, ...)`` leaf (base tensors, stacked sketch leaves,
        the ``stream_rows`` vector) is sliced by its stream axis; scalar state
        (``stream_dropped``) stays behind.  The donor half of an elastic span
        migration: the result round-trips through :meth:`adopt_stream_slice`
        on a recipient of another width.
        """
        lo, hi = int(lo), int(hi)
        if not 0 <= lo < hi <= self.num_streams:
            raise MetricsTPUUserError(f"stream_slice needs 0 <= lo < hi <= {self.num_streams}, got [{lo}, {hi})")
        out: Dict[str, torch.Tensor] = {}
        for key in self._defaults:
            value = getattr(self, key)
            if value.ndim and value.shape[0] == self.num_streams:
                out[key] = value[lo:hi].detach().cpu().clone()
        return out

    def adopt_stream_slice(self, lo: int, arrays: Dict[str, Any]) -> int:
        """Write a donor's :meth:`stream_slice` into local rows from ``lo``; returns
        the number of rows adopted.

        Row assignment, not a fold: each global stream's full state lives on
        one donor, so placing the rows reproduces the donor's accumulation bit
        for bit.
        """
        if not arrays:
            return 0
        lo = int(lo)
        patches = {key: torch.as_tensor(value) for key, value in arrays.items()}
        widths = {int(p.shape[0]) for p in patches.values()}
        if len(widths) != 1:
            raise MetricsTPUUserError(f"ragged stream slice: row counts {sorted(widths)} disagree")
        n = widths.pop()
        if not 0 <= lo <= lo + n <= self.num_streams:
            raise MetricsTPUUserError(
                f"slice rows [{lo}, {lo + n}) fall outside this metric's [0, {self.num_streams}) stream axis"
            )
        for key in patches:
            if key not in self._defaults:
                raise MetricsTPUUserError(
                    f"slice carries unknown state {key!r}; donor and recipient must run the same metric schema"
                )
        rows = 0
        for key, patch in patches.items():
            live = getattr(self, key)
            if tuple(patch.shape[1:]) != tuple(live.shape[1:]):
                raise MetricsTPUUserError(
                    f"slice state {key!r} has per-stream shape {tuple(patch.shape[1:])}, "
                    f"metric expects {tuple(live.shape[1:])}"
                )
            new = live.clone()
            new[lo : lo + n] = patch.to(device=self.device, dtype=live.dtype)
            setattr(self, key, new)
            if key == self._ROWS_STATE:
                rows = int(patch.sum())
        # adopted rows were never part of a gathered sync prefix, and any cached compute predates them
        self._delta_cache.clear()
        self._computed = None
        self._update_count += rows
        return n

    # ------------------------------------------------------------------- misc
    def _ckpt_extra_state(self) -> Dict[str, Any]:
        # runtime-locked base attributes (a classifier's input ``mode``) live on
        # the base, so a checkpoint restore must route them there
        out = super()._ckpt_extra_state()
        base_extra = self._base._ckpt_extra_state()
        if base_extra:
            out["base"] = base_extra
        return out

    def _ckpt_load_extra_state(self, extra: Dict[str, Any]) -> None:
        base_extra = extra.get("base")
        super()._ckpt_load_extra_state({k: v for k, v in extra.items() if k != "base"})
        if isinstance(base_extra, dict):
            self._base._ckpt_load_extra_state(base_extra)

    def reset(self) -> None:
        super().reset()
        self._base.reset()
        self._active_reported = 0

    def _finish_sync_report(
        self, report: Dict[str, Any], backend: Any, start: float, telemetry: Optional[Dict[str, Any]] = None
    ) -> None:
        super()._finish_sync_report(report, backend, start, telemetry)
        gathered = int(report.get("bytes_gathered") or 0)
        if gathered:
            # attribute the stacked states' sync traffic to the multistream layer
            _obs.counter_inc("multistream.sync_bytes", gathered, metric=type(self._base).__name__)

    def __repr__(self) -> str:
        return f"{type(self).__name__}(base={type(self._base).__name__}, num_streams={self.num_streams})"
