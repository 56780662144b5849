"""The KLL sketch's chunk fold: the hand-written CUDA kernel, its plain version and its loader.

Counterpart of ``metrics_tpu/streaming/sketches.py::_fold_chunks`` (a
``lax.scan``, not a Pallas kernel): fold ``n`` fixed-width chunks, in order,
into each of ``S`` sketches, advancing each sketch's PRNG key once per chunk
and compacting full levels top-down before each insert.  ``kll_update`` folds
its values' chunks at level 0; ``kll_merge`` folds each other state's rows,
two half-row chunks per level ``h`` entering at ``h``.

:func:`kll_fold` works in place.  CUDA tensors launch ``csrc/kll_fold.cu``
and CPU tensors take :func:`kll_fold_plain`.  The kernel runs the fold in
four stages, ``L + 2`` launches on the current stream: a serial plan per
sketch (the key chain, the coins and the level counts, integers only; it
emits one event per compaction and the runs each row is made of), the
compactions of each level below the top in parallel across the card, the
top level's compactions in order, and the rows' assembly.  The two agree
bitwise on every leaf: they compare and move floats and never do arithmetic
on them.  ``tests/test_torch_kll_plan.py`` holds a plain model of the four
stages against :func:`kll_fold_plain` and the JAX package on the CPU; the
kernel itself runs only on a card: ``python -m pytest --noconftest -p
no:cacheprovider -m cuda tests/test_torch_cuda.py`` and ``python3
chip_smoke.py`` (phase 11) hold it against the plain version.  The library
is built with ``nvcc`` at first use (:mod:`metrics_tpu_torch.ops._build`); a
failed build or launch raises.
"""

import ctypes
import functools
from typing import List, Tuple

import torch

from metrics_tpu_torch.ops import _build
from metrics_tpu_torch.streaming._threefry import as_uint32, as_words, randint_bits, threefry2x32

_SOURCE = _build.CSRC / "kll_fold.cu"

#: the widest sketch one thread block sorts in shared memory (a 16384-slot row
#: pads to 16384 eight-byte sort keys beside its 4-byte values: 192 KB of 227 KB)
MAX_CAPACITY = 16384
#: the most levels the kernel's plan tracks (one bit of a 64-bit mask each)
MAX_LEVELS = 64


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    pointer, i64 = ctypes.c_void_p, ctypes.c_int64
    # (buf, cnt, key, nc, chunks, valids, levels, events, runs, rows, slab, S, n, L, K, EV, R, EB, stream)
    lib.kll_fold.argtypes = [pointer] * 11 + [i64] * 7 + [pointer]
    lib.kll_fold.restype = ctypes.c_int
    return lib


def check_capacity(capacity: int, device: torch.device) -> None:
    """Raise where a sketch of ``capacity`` slots per level would live on a CUDA device
    that the kernel cannot fold it on (wider than :data:`MAX_CAPACITY`)."""
    if torch.device(device).type == "cuda" and capacity > MAX_CAPACITY:
        raise ValueError(
            f"a KLL sketch on CUDA holds at most {MAX_CAPACITY} slots per level (the rows one "
            f"thread block sorts in shared memory), got capacity {capacity}"
        )


def _check(buf, cnt, key, nc, chunks, valids, levels) -> None:
    tensors = (buf, cnt, key, nc, chunks, valids, levels)
    if not all(isinstance(t, torch.Tensor) for t in tensors):
        raise TypeError("kll_fold takes seven tensors")
    if buf.ndim != 3:
        raise ValueError(f"kll_fold takes buf (S, L, K), got {tuple(buf.shape)}")
    s, levels_n, k = buf.shape
    n = levels.shape[0] if levels.ndim == 1 else -1
    expected = {
        "cnt": (cnt, (s, levels_n), torch.int32),
        "key": (key, (s, 2), torch.uint32),
        "nc": (nc, (s,), torch.int32),
        "chunks": (chunks, (s, n, k // 2), torch.float32),
        "valids": (valids, (s, n), torch.int32),
        "levels": (levels, (n,), torch.int32),
    }
    if buf.dtype != torch.float32 or k < 2 or k % 2:
        raise ValueError(f"kll_fold takes float32 rows of an even capacity, got {buf.dtype} rows of {k}")
    for name, (t, shape, dtype) in expected.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"kll_fold: {name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
    device = buf.device
    if any(t.device != device for t in tensors):
        raise ValueError(f"kll_fold takes tensors on one device, got {[str(t.device) for t in tensors]}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"kll_fold runs on CPU or CUDA tensors, got {device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kll_fold takes contiguous tensors")


def _sorted_row(row: torch.Tensor) -> torch.Tensor:
    """``jnp.sort(row)``: stable, ``-0.0`` equal to ``+0.0`` and every NaN equal and last, each value's bits kept."""
    key = torch.where(row == 0, torch.zeros_like(row), row)
    key = torch.where(torch.isnan(row), torch.full_like(row, float("nan")), key)
    return row[torch.sort(key, stable=True).indices]


def _key_chain(k0: int, k1: int, n: int) -> Tuple[Tuple[int, int], List[Tuple[int, int]]]:
    """The key after ``n`` splits and the subkey of each split, on the host."""
    subs = []
    for _ in range(n):
        subs.append(threefry2x32(k0, k1, 0, 1))
        k0, k1 = threefry2x32(k0, k1, 0, 0)
    return (k0, k1), subs


def kll_fold_plain(buf, cnt, key, nc, chunks, valids, levels) -> None:
    """The kernel's function in plain PyTorch, in place: ``_fold_chunks``'s loop, chunk by chunk.

    The level counts, the key chain and the chunks' valid counts and levels
    are read to the host once and the loop branches there; the rows stay
    tensors on their device.
    """
    _check(buf, cnt, key, nc, chunks, valids, levels)
    s_count, n_levels, k = buf.shape
    half = k // 2
    n = chunks.shape[1]
    if n == 0 or s_count == 0:
        return
    counts, compactions = cnt.tolist(), nc.tolist()
    keys = as_words(key).tolist()
    valid_of, level_of = valids.tolist(), levels.tolist()
    lanes = torch.arange(half, device=buf.device)
    inf = torch.tensor(float("inf"), device=buf.device)
    for s in range(s_count):
        keys[s], subs = _key_chain(keys[s][0], keys[s][1], n)
        coins = randint_bits(torch.tensor(subs, dtype=torch.int64), n_levels).tolist()
        rows, c = buf[s], counts[s]
        for t in range(n):
            valid, level = valid_of[s][t], level_of[t]
            if valid <= 0:
                continue
            for h in range(n_levels - 1, level - 1, -1):
                if c[h] <= k - half:
                    continue
                bit = coins[t][h]
                n_surv = max((c[h] + 1 - bit) // 2, 0)
                picks = torch.where(lanes < n_surv, _sorted_row(rows[h])[bit + 2 * lanes], inf)
                if h + 1 < n_levels:
                    start = min(max(c[h + 1], 0), k - half)
                    rows[h + 1, start : start + half] = picks
                    rows[h] = inf
                    c[h], c[h + 1] = 0, c[h + 1] + n_surv
                else:
                    rows[h, :half] = picks
                    rows[h, half:] = inf
                    c[h] = n_surv
                compactions[s] += 1
            start = min(max(c[level], 0), k - half)
            rows[level, start : start + half] = torch.where(lanes < valid, chunks[s, t], inf)
            c[level] += valid
    cnt.copy_(torch.tensor(counts, dtype=torch.int32))
    nc.copy_(torch.tensor(compactions, dtype=torch.int32))
    key.copy_(as_uint32(torch.tensor(keys, dtype=torch.int64)))


def scratch_sizes(n: int, levels: int) -> Tuple[int, int, int]:
    """The kernel's scratch per sketch for ``n`` chunks into ``levels`` levels: events per level
    ``EV``, runs per level ``R`` and events in all ``EB`` (each with a slab row of ``K / 2`` floats).

    Within the contract (counts in ``[0, K]``, valid counts at most ``K / 2``): level ``h`` gets at
    most ``n + h + 1`` runs from outside (its initial row, chunks, one per compaction at ``h - 1``)
    and each compaction consumes at least one of them; the top level also appends its own
    survivors, one per compaction; and a compaction of ``c > K / 2`` entries keeps at most
    ``(c + 1) / 2``, so it removes at least ``K / 4`` of the at most ``L K + n K / 2`` entries there
    ever are.  ``tests/test_torch_kll_plan.py`` checks the three on its plans.
    """
    per_level = n + levels + 1
    return per_level, 2 * per_level, 2 * n + 4 * levels


def kll_fold(buf, cnt, key, nc, chunks, valids, levels) -> None:
    """Fold ``chunks`` into ``S`` KLL sketches in place.

    ``buf (S, L, K)`` float32, ``cnt (S, L)`` int32, ``key (S, 2)`` uint32 and
    ``nc (S,)`` int32 are the sketches' leaves; ``chunks (S, n, K/2)`` float32
    holds ``valids (S, n)`` int32 values at the start of each chunk, and
    ``levels (n,)`` int32 the level each chunk enters at.  CPU tensors take
    :func:`kll_fold_plain`; CUDA tensors launch the kernel's four stages on the
    current stream, ``L + 2`` device operations per call (none when ``S`` or
    ``n`` is 0), with scratch from :func:`scratch_sizes`.
    ``kll_fold.launches`` counts the calls that launch it.

    The leaves are the sketch's, with its layout invariant (``cnt[h]`` in
    ``[0, K]``, +inf past it) and at most ``K / 2`` values a chunk, as
    ``kll_update`` and ``kll_merge`` make them.
    """
    if isinstance(buf, torch.Tensor) and buf.device.type == "cpu":
        kll_fold_plain(buf, cnt, key, nc, chunks, valids, levels)
        return
    _check(buf, cnt, key, nc, chunks, valids, levels)
    s_count, n_levels, k = buf.shape
    check_capacity(k, buf.device)
    n = chunks.shape[1]
    per_level, runs_per_level, n_events = scratch_sizes(n, n_levels)
    if n_levels > MAX_LEVELS or n_events >= 1 << 30:  # a run names its chunk or event in 30 bits
        raise ValueError(f"kll_fold on CUDA folds at most {MAX_LEVELS} levels and 2**29 chunks a call, "
                         f"got {n_levels} levels and {n} chunks")
    if n == 0 or s_count == 0:
        return
    rows = s_count * n_levels
    # int32 words: events (int4 each), runs (int2), rows (int4); the slab holds K / 2 floats per event.
    # Both return to PyTorch's caching allocator when this returns; the stream orders their reuse after the fold.
    ints = torch.empty(rows * (4 * per_level + 2 * runs_per_level + 4), dtype=torch.int32, device=buf.device)
    slab = torch.empty(s_count * n_events * (k // 2), dtype=torch.float32, device=buf.device)
    base = ints.data_ptr()
    runs = base + rows * per_level * 16
    row_info = runs + rows * runs_per_level * 8
    with torch.cuda.device(buf.device):
        err = _library().kll_fold(
            buf.data_ptr(), cnt.data_ptr(), key.data_ptr(), nc.data_ptr(), chunks.data_ptr(),
            valids.data_ptr(), levels.data_ptr(), base, runs, row_info, slab.data_ptr(),
            s_count, n, n_levels, k, per_level, runs_per_level, n_events,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"kll_fold kernel launch failed with CUDA error {err}")
    kll_fold.launches += 1


kll_fold.launches = 0
