"""The KLL fold's four stages, modelled in plain PyTorch, against the walk and the JAX package.

``metrics_tpu_torch/ops/csrc/kll_fold.cu`` does not walk a sketch's chunks
one at a time.  It splits the fold into

1. **plan**: the key chain, the coins and the level counts, integers only,
   walked serially; it emits an event table (one event per compaction: its
   level, ``c``, coin, and the runs that make up row ``h`` at that moment)
   and the runs of each row's final contents;
2. **execute**: every event of level ``h < L - 1`` reads only runs that
   exist before level ``h`` runs (the initial row, chunks, survivors of
   level ``h - 1``), so a level's events run in any order;
3. **top**: the top level compacts in place, so its events run in order;
4. **assemble**: each touched row is its final runs, then ``+inf``.

:func:`plan` (stage 1), :func:`compact` (one event of stages 2 and 3) and
:func:`fold_model` (the four in order) model them in plain Python and
PyTorch, used only by these tests.  They are held bitwise (every
leaf: ``buf``, ``cnt``, ``key``, ``n``, ``nc``) against
:func:`metrics_tpu_torch.ops.kll.kll_fold_plain` and the JAX package's
``kll_update``/``kll_merge``/``_fold_chunks``, on seeded inputs with ties,
``+-0.0`` and non-finite values.  The kernel on the card is held to the plain
version in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

The plan relies on the slice-write clamp ``min(cnt, K - half)`` never
firing: each write's start is asserted to be ``cnt`` itself, within
``[0, K - half]``.  :func:`test_the_slice_write_clamp_never_fires` shows why
on random valid states (every count in ``[0, K]``, every valid count at most
``K / 2``): a level is checked before anything is written into it, so it
holds at most ``K - half`` entries when a chunk or survivors land, and a
compaction leaves at most ``half`` behind.  It also checks the scratch bounds
the kernel's wrapper allocates from.
"""

from dataclasses import dataclass
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.streaming import sketches as jsk
from metrics_tpu_torch.ops import kll
from metrics_tpu_torch.streaming import _threefry
from metrics_tpu_torch.streaming import sketches as psk

ROW, CHUNK, SURVIVORS = "row", "chunk", "survivors"  # the three sources a run reads


# ---------------------------------------------------------------------- the model
@dataclass
class Plan:
    """Stage 1's output for one sketch."""

    events: List[List[Tuple[int, int, int, int, int]]]  # per level: (e, c, bit, first run, end run)
    runs: List[List[Tuple[str, int, int, int]]]  # per level: (source, index, position in the row, length)
    final: List[int]  # per level: the first run of the row's final contents
    touched: List[bool]  # per level: written to or compacted
    counts: List[int]
    n_events: int


def coins_of(k0: int, k1: int, n: int, levels: int) -> Tuple[Tuple[int, int], List[List[int]]]:
    """The key after ``n`` splits and each chunk's coin per level (stage 1's chain)."""
    key, subs = kll._key_chain(k0, k1, n)
    if not n:
        return key, []
    return key, _threefry.randint_bits(torch.tensor(subs, dtype=torch.int64), levels).tolist()


def plan(counts: List[int], coins: List[List[int]], valids: List[int], levels: List[int], n_levels: int, k: int) -> Plan:
    """Stage 1: the top-down walk of ``_fold_chunks`` on the counts alone."""
    half = k // 2
    c = list(counts)
    runs = [[(ROW, h, 0, c[h])] if c[h] > 0 else [] for h in range(n_levels)]
    final, touched = [0] * n_levels, [False] * n_levels
    events: List[list] = [[] for _ in range(n_levels)]
    full = sum(1 << h for h in range(n_levels) if c[h] > k - half)
    e = 0

    def append(h, run):
        _, _, pos, length = run
        assert 0 <= pos <= k - half and 0 < length <= half, run  # the slice write's clamp would not move it
        runs[h].append(run)
        touched[h] = True

    for t, (valid, level) in enumerate(zip(valids, levels)):
        if valid <= 0:
            continue  # an all-padding chunk only advances the key
        pending = full & ~((1 << level) - 1)  # the levels the top-down pass compacts: no write into them comes first
        while pending:
            h = pending.bit_length() - 1
            pending &= ~(1 << h)
            bit = coins[t][h]
            n_surv = max((c[h] + 1 - bit) // 2, 0)
            events[h].append((e, c[h], bit, final[h], len(runs[h])))
            touched[h] = True
            full &= ~(1 << h)
            if h + 1 < n_levels:
                append(h + 1, (SURVIVORS, e, c[h + 1], n_surv))
                c[h + 1] += n_surv
                if c[h + 1] > k - half:
                    full |= 1 << (h + 1)
                c[h], final[h] = 0, len(runs[h])
            else:  # the top level keeps its survivors in place
                final[h] = len(runs[h])
                append(h, (SURVIVORS, e, 0, n_surv))
                c[h] = n_surv
                assert n_surv <= k - half
            e += 1
        append(level, (CHUNK, t, c[level], valid))
        c[level] += valid
        if c[level] > k - half:
            full |= 1 << level
    return Plan(events, runs, final, touched, c, e)


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """The kernel's order key: unsigned, ``-0.0`` equal to ``+0.0``, every NaN equal and after ``+inf``."""
    x = torch.where(x == 0, torch.zeros_like(x), x)
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 1 << 31, 0xFFFFFFFF - u, u | 1 << 31)


def compact(values: torch.Tensor, bit: int, k: int) -> torch.Tensor:
    """An event's survivors from its ``c`` gathered values: the picks ``bit + 2 i`` of the row of
    ``k`` slots (the values, then ``k - c`` slots of ``+inf``) sorted stably, without sorting the padding."""
    c = values.numel()
    ordered = values[torch.sort(_order_key(values), stable=True).indices]
    nans = int(torch.isnan(values).sum())
    picks = bit + 2 * torch.arange(max((c + 1 - bit) // 2, 0))
    # the padding sits after every value but the NaNs: sorted slot j of the full row
    padded = (picks >= c - nans) & (picks < k - nans)
    source = torch.where(picks < c - nans, picks, picks - (k - c)).clamp(0, max(c - 1, 0))
    return torch.where(padded, torch.tensor(float("inf")), ordered[source])


def _gather(runs, sources) -> torch.Tensor:
    parts, at = [], 0
    for kind, index, pos, length in runs:
        assert pos == at, runs  # the runs tile the row: the gather is a concatenation
        parts.append(sources[kind](index)[:length])
        at += length
    return torch.cat(parts) if parts else torch.zeros((0,))


def fold_model(buf, cnt, key, nc, chunks, valids, levels) -> List[Plan]:
    """``kll_fold``'s function through the four stages, in place, one sketch at a time; returns the plans."""
    s_count, n_levels, k = buf.shape
    n = chunks.shape[1]
    plans = []
    for s in range(s_count):
        keys = _threefry.as_words(key[s]).tolist()
        new_key, coins = coins_of(keys[0], keys[1], n, n_levels)
        p = plan(cnt[s].tolist(), coins, valids[s].tolist(), levels.tolist(), n_levels, k)
        slab = {}
        initial = buf[s].clone()
        sources = {ROW: lambda h: initial[h], CHUNK: lambda t: chunks[s, t], SURVIVORS: lambda e: slab[e]}
        # stage 2: each level's events in reverse order (any order does), levels bottom-up; stage 3: the top in order
        for h in range(n_levels):
            order = p.events[h] if h == n_levels - 1 else reversed(p.events[h])
            for e, c, bit, begin, end in order:
                values = _gather(p.runs[h][begin:end], sources)
                assert values.numel() == c
                slab[e] = compact(values, bit, k)
        # stage 4
        for h in range(n_levels):
            if p.touched[h]:
                row = _gather(p.runs[h][p.final[h]:], sources)
                buf[s, h] = torch.cat([row, torch.full((k - row.numel(),), float("inf"))])
        cnt[s] = torch.tensor(p.counts, dtype=torch.int32)
        nc[s] += p.n_events
        key[s] = _threefry.as_uint32(torch.tensor(new_key, dtype=torch.int64))
        plans.append(p)
    return plans


# ---------------------------------------------------------------------- helpers
def _stream(seed: int, size: int, nonfinite: bool = True) -> np.ndarray:
    """Values on a grid of tenths (ties), both signed zeros and, optionally, NaN and both infinities."""
    rng = np.random.default_rng(seed)
    v = np.round(rng.normal(size=size), 1).astype(np.float32)
    v[::13], v[5::17] = 0.0, -0.0
    if nonfinite and size > 10:
        v[[3, 7, 9]] = [np.nan, np.inf, -np.inf]
    return v


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _same_tree(a: dict, b: dict, tag: str = "") -> None:
    assert sorted(a) == sorted(b), tag
    for name in a:
        x, y = _np(a[name]), _np(b[name])
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), (tag, name)


def _torch_state(state: dict) -> dict:
    return {name: torch.from_numpy(np.array(v)) for name, v in state.items()}


@pytest.fixture
def through(monkeypatch):
    """``through(fold, fn)``: ``fn()`` with the sketch functions folding through ``fold``."""

    def run(fold, fn):
        with monkeypatch.context() as m:
            m.setattr(psk, "kll_fold", fold)
            return fn()

    return run


def _model_fold(*args):
    fold_model(*args)


# jitted once per shape: the JAX package's update, merge of two and direct fold
_jax_update = jax.jit(jsk.kll_update)
_jax_merge2 = jax.jit(lambda a, b: jsk.kll_merge([a, b]))
_jax_fold = jax.jit(jsk._fold_chunks, static_argnums=(6,))
_jax_update_s = jax.jit(jax.vmap(jsk.kll_update))
_jax_merge2_s = jax.jit(jax.vmap(lambda a, b: jsk.kll_merge([a, b])))


# ---------------------------------------------------------------------- updates and merges
@pytest.mark.parametrize("capacity,max_items,sizes", [
    (8, 1 << 5, (301, 301, 301)),  # 4 levels: the top saturates
    (10, 1 << 8, (303, 303, 303)),
    (256, 1 << 12, (2001, 2001, 2001)),
    (2048, 1 << 15, (9000, 9000, 9000)),
])
def test_updates_and_merges_bitwise(through, capacity, max_items, sizes):
    """Full and ragged last chunks, non-finite values dropped, then a merge of three states."""
    jst = jsk.kll_init(capacity, seed=3, max_items=max_items)
    plain = model = psk.kll_init(capacity, seed=3, max_items=max_items, device="cpu")
    for step, size in enumerate(sizes):
        v = _stream(step, size)
        jst = _jax_update(jst, v)
        plain = through(kll.kll_fold_plain, lambda: psk.kll_update(plain, torch.from_numpy(v)))
        model = through(_model_fold, lambda: psk.kll_update(model, torch.from_numpy(v)))
        _same_tree(jst, model, f"update {step}, JAX")
        _same_tree(plain, model, f"update {step}, plain")
    assert int(model["nc"]) > 0 and int(model["cnt"][1:].sum()) > 0
    other = _jax_update(jsk.kll_init(capacity, seed=9, max_items=max_items), _stream(9, sizes[0]))
    empty = jsk.kll_init(capacity, seed=1, max_items=max_items)
    want = _jax_merge2(_jax_merge2(jst, other), empty)
    states = [model, _torch_state(other), _torch_state(empty)]
    _same_tree(want, through(_model_fold, lambda: psk.kll_merge(states)), "merge, JAX")
    _same_tree(through(kll.kll_fold_plain, lambda: psk.kll_merge(states)),
               through(_model_fold, lambda: psk.kll_merge(states)), "merge, plain")
    _same_tree(_jax_merge2(empty, jst), through(_model_fold, lambda: psk.kll_merge([states[2], model])), "into empty")


def test_a_deep_state_loaded_mid_stream(through):
    """A JAX sketch deep into a stream (levels 0-4 holding runs of many sizes) continues bitwise."""
    capacity, max_items = 10, 1 << 8
    jst = jsk.kll_init(capacity, seed=7, max_items=max_items)
    for step in range(12):
        jst = _jax_update(jst, _stream(40 + step, 303))
    state = _torch_state(jst)
    assert int(state["cnt"][3:].sum()) > 0
    v = _stream(99, 303)
    want = _jax_update(jst, v)
    _same_tree(want, through(_model_fold, lambda: psk.kll_update(state, torch.from_numpy(v))), "JAX")
    _same_tree(through(kll.kll_fold_plain, lambda: psk.kll_update(state, torch.from_numpy(v))),
               through(_model_fold, lambda: psk.kll_update(state, torch.from_numpy(v))), "plain")


def test_the_top_level_saturates_and_compacts_in_place(through):
    """``max_items`` far below the stream: the top level's events form a chain that stage 3 runs in order."""
    capacity, max_items = 8, 1 << 5
    jst = jsk.kll_init(capacity, seed=2, max_items=max_items)
    model = psk.kll_init(capacity, seed=2, max_items=max_items, device="cpu")
    plans = []
    record = lambda *args: plans.extend(fold_model(*args))  # noqa: E731
    for step in range(3):
        v = _stream(60 + step, 301)
        jst = _jax_update(jst, v)
        model = through(record, lambda: psk.kll_update(model, torch.from_numpy(v)))
        _same_tree(jst, model, f"update {step}")
    top = sum(len(p.events[-1]) for p in plans)
    assert top >= 10, top


def test_batched_sketches_update_and_merge(through):
    """S = 8 sketches folded in one call, then merged slot-wise, against the plain walk and JAX's vmap."""
    capacity, max_items, sketches = 8, 1 << 5, 8
    jinit = jax.vmap(lambda key: jsk.kll_init(capacity, max_items=max_items) | {"key": key})(
        jnp.stack([jax.random.PRNGKey(i) for i in range(sketches)]))
    init = _torch_state(jinit)
    values = np.stack([_stream(70 + i, 257) for i in range(sketches)])
    jst = _jax_update_s(jinit, values)
    model = through(_model_fold, lambda: psk.kll_update(init, torch.from_numpy(values)))
    _same_tree(jst, model, "update, JAX")
    _same_tree(through(kll.kll_fold_plain, lambda: psk.kll_update(init, torch.from_numpy(values))), model, "update, plain")
    merged = through(_model_fold, lambda: psk.kll_merge([model, init, model]))
    _same_tree(through(kll.kll_fold_plain, lambda: psk.kll_merge([model, init, model])), merged, "merge, plain")
    _same_tree(_jax_merge2_s(_jax_merge2_s(jst, jinit), jst), merged, "merge, JAX")


# ---------------------------------------------------------------------- raw chunks
def _raw_chunks(seed: int, n: int, half: int, sort: bool, nan_inside: bool = False):
    """Chunks with random valid counts (odd ones, zeros: all padding), values past them ``+inf``."""
    rng = np.random.default_rng(seed)
    valids = rng.integers(-1, half + 1, n).astype(np.int32)
    valids[rng.random(n) < 0.3] = half
    chunks = np.full((n, half), np.inf, np.float32)
    for t, v in enumerate(valids):
        x = _stream(seed * 1000 + t, max(int(v), 0), nonfinite=False)
        if nan_inside and v > 2 and t % 3 == 0:
            x[1] = np.nan  # the plain walk sorts a NaN after the padding; the kernel's picks must too
        chunks[t, : max(int(v), 0)] = np.sort(x, kind="stable") if sort else x
    return chunks, valids


@pytest.mark.parametrize("capacity,n_levels", [(8, 4), (10, 5)])
@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
def test_partial_and_padding_chunks_against_jax(capacity, n_levels, level, sort):
    """Many short runs in a row (odd counts), all-padding chunks, unsorted runs: one fold, three ways."""
    half = capacity // 2
    chunks, valids = _raw_chunks(capacity + level, 90, half, sort)
    assert (valids <= 0).any() and (valids % 2 == 1).any()
    jst = _jax_update(jsk.kll_init(capacity, seed=4, max_items=capacity * ((1 << n_levels) - 1)),
                      _stream(5, 301 if capacity == 8 else 303))
    state = _torch_state(jst)
    assert state["buf"].shape[0] == n_levels
    buf, cnt, key, nc = jax.device_get(_jax_fold(jst["buf"], jst["cnt"], jst["key"], jst["nc"],
                                                 jnp.asarray(chunks), jnp.asarray(valids), level))
    want = {"buf": buf, "cnt": cnt, "key": key, "nc": np.asarray(nc).reshape(1)}
    levels = torch.full((len(valids),), level, dtype=torch.int32)
    for fold in (kll.kll_fold_plain, fold_model):
        got = {name: state[name].clone()[None] for name in ("buf", "cnt", "key", "nc")}
        fold(got["buf"], got["cnt"], got["key"], got["nc"].reshape(1), torch.from_numpy(chunks)[None],
             torch.from_numpy(valids)[None], levels)
        _same_tree(want, {name: v[0] if name != "nc" else v.reshape(1) for name, v in got.items()}, fold.__name__)


def test_mixed_levels_and_nan_inside_runs_against_the_plain_walk():
    """Chunks entering at every level in one call (as a merge folds), S = 3, NaN among valid entries."""
    capacity, n_levels, sketches, n = 12, 5, 3, 120
    half = capacity // 2
    rng = np.random.default_rng(17)
    inits = []
    for s in range(sketches):
        st = psk.kll_init(capacity, seed=s, max_items=capacity * ((1 << n_levels) - 1), device="cpu")
        inits.append(psk.kll_update(st, torch.from_numpy(_stream(s, 4 * capacity + 3))))
    state = {name: torch.stack([st[name] for st in inits]) for name in ("buf", "cnt", "key", "nc")}
    raw = [_raw_chunks(20 + s, n, half, sort=bool(s % 2), nan_inside=True) for s in range(sketches)]
    chunks = torch.from_numpy(np.stack([c for c, _ in raw]))
    valids = torch.from_numpy(np.stack([v for _, v in raw]))
    levels = torch.from_numpy(rng.integers(0, n_levels, n).astype(np.int32))
    plain = {name: v.clone() for name, v in state.items()}
    model = {name: v.clone() for name, v in state.items()}
    kll.kll_fold_plain(plain["buf"], plain["cnt"], plain["key"], plain["nc"], chunks, valids, levels)
    plans = fold_model(model["buf"], model["cnt"], model["key"], model["nc"], chunks, valids, levels)
    _same_tree(plain, model)
    assert torch.isnan(model["buf"]).any()  # a NaN survived a compaction somewhere
    assert all(p.n_events > 0 for p in plans)


# ---------------------------------------------------------------------- the stages on their own
def test_the_event_table_accounts_for_every_compaction_and_count():
    """Stage 1 alone: its events are ``nc``'s increase, its counts ``cnt``, and the kernel's scratch bounds hold."""
    capacity, max_items = 8, 1 << 7
    state = psk.kll_update(psk.kll_init(capacity, seed=6, max_items=max_items, device="cpu"),
                           torch.from_numpy(_stream(6, 97)))
    n_levels, half = state["buf"].shape[0], capacity // 2
    chunks, valids = _raw_chunks(8, 150, half, sort=True)
    levels = torch.from_numpy(np.random.default_rng(8).integers(0, 2, 150).astype(np.int32))
    plain = {name: state[name].clone()[None] for name in ("buf", "cnt", "key", "nc")}
    kll.kll_fold_plain(plain["buf"], plain["cnt"], plain["key"], plain["nc"].reshape(1),
                       torch.from_numpy(chunks)[None], torch.from_numpy(valids)[None], levels)
    words = _threefry.as_words(state["key"]).tolist()
    new_key, coins = coins_of(words[0], words[1], 150, n_levels)
    p = plan(state["cnt"].tolist(), coins, valids.tolist(), levels.tolist(), n_levels, capacity)
    assert p.n_events == int(plain["nc"][0]) - int(state["nc"]) > 0
    assert p.counts == plain["cnt"][0].tolist()
    assert list(new_key) == _threefry.as_words(plain["key"][0]).tolist()
    _check_scratch_bounds(p, len(valids), n_levels)


def _check_scratch_bounds(p: Plan, n: int, n_levels: int) -> None:
    """The sizes ``ops/kll.py`` allocates: events per level, runs per level, events in all."""
    per_level, runs_per_level, n_events = kll.scratch_sizes(n, n_levels)
    assert all(len(ev) <= per_level for ev in p.events)
    assert all(len(r) <= runs_per_level for r in p.runs)
    assert p.n_events <= n_events


@pytest.mark.parametrize("capacity", [8, 10, 64])
def test_the_slice_write_clamp_never_fires(capacity):
    """Random valid states and inputs, counts only: every write lands at ``cnt`` (``plan`` asserts it),
    counts stay in ``[0, K]`` and the scratch bounds hold."""
    rng = np.random.default_rng(capacity)
    half = capacity // 2
    for trial in range(40):
        n_levels = int(rng.integers(1, 7))
        n = int(rng.integers(1, 200))
        counts = rng.integers(0, capacity + 1, n_levels).tolist()  # full rows, overfull rows, empty rows
        valids = rng.integers(-2, half + 1, n)
        valids[rng.random(n) < 0.5] = half
        levels = rng.integers(0, n_levels, n) if trial % 2 else np.zeros(n, np.int64)
        coins = rng.integers(0, 2, (n, n_levels)).tolist()
        p = plan(counts, coins, valids.tolist(), levels.tolist(), n_levels, capacity)
        assert all(0 <= c <= capacity for c in p.counts), p.counts
        _check_scratch_bounds(p, n, n_levels)
