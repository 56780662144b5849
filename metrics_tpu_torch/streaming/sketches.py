"""Fixed-shape mergeable sketches (counterpart of ``metrics_tpu/streaming/sketches.py``).

* a KLL quantile sketch: a fixed ``(levels, capacity)`` buffer where level
  ``h`` holds items of weight ``2**h``; a full level is compacted (sorted,
  every other element promoted one level up, the parity a coin flip);
* an A-Res weighted reservoir: each item draws the key ``u ** (1/w)`` and the
  reservoir keeps the ``capacity`` largest keys.

Both merge: ``kll_merge`` / ``reservoir_merge`` fold any number of states
into one, which is how they ride the sync path as a ``"sketch"`` reduce.

The states equal the JAX package's leaf for leaf: the coin flips and the
uniform draws are ``jax.random``'s threefry bits, computed from the state's
own ``key`` leaf (:mod:`metrics_tpu_torch.streaming._threefry`), so a state
loaded from the JAX package continues as it would have there.  The key leaf
is a ``(2,)`` ``torch.uint32`` tensor, as JAX holds it.

Every sketch function runs on the device of the state it is given; the KLL
fold launches ``ops/csrc/kll_fold.cu`` on a CUDA state
(:func:`metrics_tpu_torch.ops.kll.kll_fold`) and takes its plain version on a
CPU state.  ``kll_update`` and ``kll_merge`` also take states with a leading
batch dimension of ``S`` sketches (``buf (S, L, K)``), folded in one launch:
a ring buffer of sketches merges slot-wise that way.

Layout invariants (relied on by merge and sync): ``buf`` rows keep their
``cnt[h]`` valid entries contiguous at the row start, and every slot at index
``>= cnt[h]`` holds ``+inf``; non-finite inputs never enter a row.
"""

import math
from typing import Any, Dict, Optional, Sequence, Union

import torch

from metrics_tpu_torch.ops.kll import check_capacity, kll_fold
from metrics_tpu_torch.streaming import _threefry
from metrics_tpu_torch.utils.data import _total_order_keys
from metrics_tpu_torch.wrappers._resample import bootstrap_resample_indices

__all__ = [
    "DEFAULT_CAPACITY",
    "DEFAULT_MAX_ITEMS",
    "kll_init",
    "kll_update",
    "kll_merge",
    "kll_quantile",
    "kll_cdf",
    "kll_total_weight",
    "kll_rank_error_bound",
    "reservoir_init",
    "reservoir_update",
    "reservoir_merge",
    "reservoir_values",
    "bootstrap_resample_indices",
]

DEFAULT_CAPACITY = 256
# design stream length: enough levels that items only saturate the top level
# past ~67M weighted items at the default capacity
DEFAULT_MAX_ITEMS = 1 << 26

_INF = float("inf")

State = Dict[str, torch.Tensor]


def _device(device: Union[str, torch.device]) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to build the sketch on the CPU")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"sketches live on 'cuda' or 'cpu', got {device}")
    return device


def _num_levels(capacity: int, max_items: int) -> int:
    """Smallest level count whose total capacity ``K * (2**L - 1)`` covers
    ``max_items`` weighted items; at least 4."""
    levels = 4
    while capacity * ((1 << levels) - 1) < max_items:
        levels += 1
    return levels


def kll_init(
    capacity: int = DEFAULT_CAPACITY,
    seed: int = 0,
    max_items: int = DEFAULT_MAX_ITEMS,
    device: Union[str, torch.device] = "cuda",
) -> State:
    """Fresh KLL state on ``device``: ``buf (L, K)`` of +inf, per-level counts,
    the PRNG key ``jax.random.PRNGKey(seed)``, item count ``n`` and compaction
    count ``nc``.

    ``capacity`` must be an even integer >= 8 (and at most
    :data:`metrics_tpu_torch.ops.kll.MAX_CAPACITY` on CUDA).
    """
    if capacity < 8 or capacity % 2:
        raise ValueError(f"sketch capacity must be an even integer >= 8, got {capacity}")
    device = _device(device)
    check_capacity(capacity, device)
    levels = _num_levels(capacity, max_items)
    return {
        "buf": torch.full((levels, capacity), _INF, dtype=torch.float32, device=device),
        "cnt": torch.zeros((levels,), dtype=torch.int32, device=device),
        "key": _threefry.seed(seed, device),
        "n": torch.zeros((), dtype=torch.int32, device=device),
        "nc": torch.zeros((), dtype=torch.int32, device=device),
    }


def _values_on(values: Any, device: torch.device) -> torch.Tensor:
    """``values`` as a tensor on the state's device: a tensor must already be there."""
    if isinstance(values, torch.Tensor):
        if values.device != device:
            raise ValueError(f"the sketch lives on {device}, the values on {values.device}")
        return values
    return torch.as_tensor(values, device=device)


def _stable_sort(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jnp.sort(x, axis=dim)`` of finite or +inf values: stable, with ``-0.0`` equal to ``+0.0``."""
    key = torch.where(x == 0, torch.zeros_like(x), x)
    return torch.gather(x, dim, torch.sort(key, dim=dim, stable=True).indices)


def _folded(state: State, chunks: torch.Tensor, valids: torch.Tensor, levels: torch.Tensor) -> State:
    """Copies of ``state``'s leaves with ``chunks (S, n, K/2)`` folded in (:func:`kll_fold`)."""
    buf = state["buf"]
    batched = buf.ndim == 3
    out = {k: v.clone() for k, v in state.items()}
    lead = (lambda t: t) if batched else (lambda t: t.unsqueeze(0))
    kll_fold(lead(out["buf"]), lead(out["cnt"]), lead(out["key"]), lead(out["nc"]).reshape(-1),
             chunks.contiguous(), valids.contiguous(), levels)
    return out


def kll_update(state: State, values) -> State:
    """Fold a batch of values into the sketch (weight-1 items at level 0).

    Non-finite values are dropped.  A batched state ``buf (S, L, K)`` takes
    ``values`` with a leading ``S`` axis, one row of values per sketch.
    """
    buf = state["buf"]
    batched = buf.ndim == 3
    sketches = buf.shape[0] if batched else 1
    vals = _values_on(values, buf.device).reshape(sketches, -1)
    if vals.shape[1] == 0:
        return dict(state)
    half = buf.shape[-1] // 2
    vals = vals.to(torch.float32)
    vals = torch.where(torch.isfinite(vals), vals, torch.full_like(vals, _INF))
    nchunk = -(-vals.shape[1] // half)
    pad = nchunk * half - vals.shape[1]
    if pad:
        vals = torch.cat([vals, vals.new_full((sketches, pad), _INF)], dim=1)
    chunks_raw = vals.reshape(sketches, nchunk, half)
    # a per-chunk sort makes the valid entries contiguous (non-finite values
    # became +inf and sort last), so each insert is one slice write
    chunks = _stable_sort(chunks_raw)
    valids = torch.isfinite(chunks_raw).sum(-1, dtype=torch.int32)
    levels = torch.zeros((nchunk,), dtype=torch.int32, device=buf.device)
    out = _folded(state, chunks, valids, levels)
    added = valids.sum(-1, dtype=torch.int32)
    out["n"] = state["n"] + (added if batched else added.reshape(()))
    return out


def kll_merge(states: Sequence[State]) -> State:
    """Fold any number of KLL states into the first, in order, in one fold.

    Each other state's rows enter as two half-row chunks per level ``h`` at
    level ``h`` (``clip(cnt - half * i, 0, half)`` valid entries each), as
    the JAX package merges two states; ``n`` and ``nc`` add.  The estimates
    stay within :func:`kll_rank_error_bound` of the concatenated stream
    whatever the coin flips.  Batched states ``(S, L, K)`` merge slot-wise.
    """
    states = list(states)
    if not states:
        raise ValueError("kll_merge needs at least one state")
    first = states[0]
    if len(states) == 1:
        return dict(first)
    buf = first["buf"]
    device = buf.device
    if any(o["buf"].device != device for o in states[1:]):
        raise ValueError("kll_merge takes states on one device")
    batched = buf.ndim == 3
    levels_n, capacity = buf.shape[-2:]
    half = capacity // 2
    sketches = buf.shape[0] if batched else 1
    others = states[1:]
    chunks = torch.cat([o["buf"].reshape(sketches, 2 * levels_n, half) for o in others], dim=1)
    offsets = half * torch.arange(2, dtype=torch.int32, device=device)
    valids = torch.cat([
        torch.clamp(o["cnt"].reshape(sketches, levels_n, 1) - offsets, 0, half).reshape(sketches, 2 * levels_n)
        for o in others
    ], dim=1).to(torch.int32)
    levels = torch.arange(levels_n, dtype=torch.int32, device=device).repeat_interleave(2).repeat(len(others))
    out = _folded(first, chunks, valids, levels)
    for o in others:
        out["n"] = out["n"] + o["n"]
        out["nc"] = out["nc"] + o["nc"]
    return out


kll_merge.batched_merge = True  # takes batched states: a ring of sketches merges slot-wise in one fold


def _weights(state: State):
    """Each slot's value and weight (``2**level`` where the slot holds an item, else 0),
    flattened over the levels; a batched state ``(S, L, K)`` gives ``(S, L * K)``."""
    buf, cnt = state["buf"], state["cnt"]
    levels, capacity = buf.shape[-2:]
    level_w = torch.tensor([2.0**h for h in range(levels)], dtype=torch.float32, device=buf.device)[:, None]
    slots = torch.arange(capacity, device=buf.device)[None, :]
    w = torch.where(slots < cnt[..., None], level_w, torch.zeros((), dtype=torch.float32, device=buf.device))
    lead = tuple(buf.shape[:-2])
    return buf.reshape(lead + (-1,)), w.reshape(lead + (-1,))


def kll_total_weight(state: State) -> torch.Tensor:
    """Total weight held by the sketch (the items folded in, until the top level saturates); ``(S,)``
    for a batched state ``(S, L, K)``."""
    _, w = _weights(state)
    return w.sum(-1)


def _as_query(q, device: torch.device) -> torch.Tensor:
    return torch.atleast_1d(torch.as_tensor(q, dtype=torch.float32, device=device))


def kll_quantile(state: State, q):
    """Estimated ``q``-quantile(s); scalar in, scalar out.  NaN when empty.

    A stable sort of the values, a float32 running sum of their weights and
    a left ``searchsorted``: bitwise the JAX package's below ``2**24`` total
    weight, where every partial sum is exact.  A batched state ``(S, L, K)``
    gives every sketch's estimates at once, ``(S,)`` or ``(S, Q)``: what
    ``jax.vmap`` of the estimate over the sketches gives.
    """
    vals, w = _weights(state)
    key = torch.where(vals == 0, torch.zeros_like(vals), vals)
    order = torch.sort(key, dim=-1, stable=True).indices
    sv, cw = torch.gather(vals, -1, order), torch.cumsum(torch.gather(w, -1, order), -1)
    total = cw[..., -1:]
    qa = _as_query(q, vals.device)
    idx = torch.clamp(torch.searchsorted(cw, (qa * total).contiguous(), side="left"), 0, vals.shape[-1] - 1)
    out = torch.where(total > 0, torch.gather(sv, -1, idx), torch.full_like(idx, float("nan"), dtype=torch.float32))
    return out[..., 0] if torch.as_tensor(q).ndim == 0 else out


def kll_cdf(state: State, xs):
    """Estimated CDF (fraction of weight ``<= x``) at each ``x``; NaN when empty.

    A batched state ``(S, L, K)`` takes ``xs`` ``(S, Q)`` (each sketch its own
    points) or ``(Q,)`` and gives ``(S, Q)``: what ``jax.vmap`` of the CDF over
    the sketches gives.
    """
    vals, w = _weights(state)
    xa = _as_query(xs, vals.device)
    total = w.sum(-1, keepdim=True)
    below = torch.where(vals[..., None, :] <= xa[..., :, None], w[..., None, :], torch.zeros((), device=vals.device)).sum(-1)
    out = torch.where(total > 0, below / torch.clamp(total, min=1.0), torch.full_like(below, float("nan")))
    return out[..., 0] if torch.as_tensor(xs).ndim == 0 else out


def kll_rank_error_bound(n: int, capacity: int = DEFAULT_CAPACITY) -> float:
    """Worst-case normalized rank error after ``n`` items: ``1 / n`` while
    everything fits uncompacted, else ``(H + 2) / capacity`` with ``H =
    ceil(log2(2n / capacity))`` active levels (every coin outcome)."""
    n = int(n)
    if n <= 0:
        return 0.0
    if n <= capacity:
        return 1.0 / n
    levels = math.ceil(math.log2(max(2.0 * n / capacity, 2.0)))
    return min(1.0, (levels + 2) / capacity)


# ---------------------------------------------------------------------------
# weighted reservoir (A-Res)
# ---------------------------------------------------------------------------


def _process_index() -> int:
    """This process's rank in the ``torch.distributed`` group, 0 without one
    (the counterpart of ``jax.process_index()``)."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def reservoir_init(
    capacity: int = 128, seed: int = 0, distinct: bool = True, device: Union[str, torch.device] = "cuda"
) -> State:
    """Fresh A-Res weighted reservoir on ``device``.

    ``distinct=True`` folds the process's rank into the key, so ranks that
    build identically seeded reservoirs still draw independent keys.
    """
    if capacity < 1:
        raise ValueError(f"reservoir capacity must be >= 1, got {capacity}")
    device = _device(device)
    key = _threefry.seed(seed, device)
    if distinct:
        key = _threefry.as_uint32(_threefry.fold_in(key, _process_index()))
    return {
        "rvals": torch.zeros((capacity,), dtype=torch.float32, device=device),
        "rkeys": torch.full((capacity,), -_INF, dtype=torch.float32, device=device),
        "rkey": key,
        "rseen": torch.zeros((), dtype=torch.int32, device=device),
    }


def _top(keys: torch.Tensor, values: torch.Tensor, capacity: int):
    """``lax.top_k(keys, capacity)`` and the values beside: total order, ties to the lower index."""
    idx = torch.sort(_total_order_keys(keys), descending=True, stable=True).indices[:capacity]
    return keys[idx], values[idx]


def reservoir_update(state: State, values, weights: Optional[Any] = None) -> State:
    """Fold a batch into the reservoir: each item draws key ``u ** (1/w)`` and
    the ``capacity`` largest keys survive.  Non-finite values and
    non-positive weights are dropped."""
    device = state["rkeys"].device
    vals = _values_on(values, device).reshape(-1).to(torch.float32)
    m = vals.shape[0]
    if m == 0:
        return dict(state)
    if weights is None:
        w = torch.ones((m,), dtype=torch.float32, device=device)
    else:
        w = torch.broadcast_to(_values_on(weights, device).reshape(-1).to(torch.float32), (m,))
    key, sub = _threefry.split(state["rkey"])
    u = _threefry.uniform(sub, m, 1e-7, 1.0)
    floor = torch.tensor(1e-30, dtype=torch.float32, device=device)
    keys = u ** (torch.ones((), dtype=torch.float32, device=device) / torch.maximum(w, floor))
    ok = torch.isfinite(vals) & torch.isfinite(w) & (w > 0)
    keys = torch.where(ok, keys, torch.full_like(keys, -_INF))
    topk, topv = _top(torch.cat([state["rkeys"], keys]), torch.cat([state["rvals"], vals]), state["rkeys"].shape[0])
    return {
        "rvals": topv,
        "rkeys": topk,
        "rkey": _threefry.as_uint32(key),
        "rseen": state["rseen"] + ok.sum(dtype=torch.int32),
    }


def reservoir_merge(states: Sequence[State]) -> State:
    """Keep the ``capacity`` largest keys across all reservoirs: the sample one
    reservoir over the union would have kept.  The first state's key carries on."""
    states = list(states)
    if not states:
        raise ValueError("reservoir_merge needs at least one state")
    capacity = states[0]["rkeys"].shape[0]
    topk, topv = _top(torch.cat([s["rkeys"] for s in states]), torch.cat([s["rvals"] for s in states]), capacity)
    rseen = states[0]["rseen"]
    for s in states[1:]:
        rseen = rseen + s["rseen"]
    return {"rvals": topv, "rkeys": topk, "rkey": states[0]["rkey"], "rseen": rseen.to(torch.int32)}


def reservoir_values(state: State):
    """``(values, valid_mask)``, fixed-shape; the mask is False for unfilled slots."""
    return state["rvals"], state["rkeys"] > -_INF
