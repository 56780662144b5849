"""The threefry-2x32 draws of the JAX package's sketches, reproduced bit for bit.

The JAX package keys its KLL compaction coin flips and its reservoir's
uniform draws with ``jax.random`` (threefry-2x32, with
``jax_threefry_partitionable`` on, JAX's default).  This module computes the
same bits from the same key, so the port's sketches equal the JAX package's
leaf for leaf, the key included:

* :func:`seed` is ``jax.random.PRNGKey(seed)``: ``[0, seed mod 2**32]``;
* :func:`split` is ``jax.random.split(key)``: the new key is
  ``threefry(key, (0, 0))`` and the subkey ``threefry(key, (0, 1))``;
* ``split(key, num)`` is ``jax.random.split(key, num)``: key ``i`` is ``threefry(key, (0, i))``;
* :func:`permutation` is ``jax.random.permutation(key, n)`` (KID's subsets, IS's shuffle);
* :func:`fold_in` is ``jax.random.fold_in(key, data)``: ``threefry(key, (0, data))``;
* :func:`randint_bits` is ``jax.random.randint(sub, (n,), 0, 2)``: with a
  span of 2 the high word's multiplier is 0, so bit ``i`` is
  ``(y0 ^ y1) & 1`` of ``threefry(k2, (0, i))``, where ``(k1, k2) = split(sub)``;
* :func:`uniform` is ``jax.random.uniform(sub, (m,), minval=, maxval=)``:
  ``bits >> 9 | 0x3F800000`` read as a float, minus 1, scaled and shifted as
  one fused multiply-add (XLA fuses it), then clamped below at ``minval``.

Keys are ``(..., 2)`` tensors of 32-bit words held in int64 (or
``torch.uint32`` at a state's boundary, see :func:`as_words`).  The rounds
work on Python ints and on int64 tensors alike, masked to 32 bits, so a
serial chain of keys runs on the host without a launch per step.
``ops/csrc/kll_fold.cu`` computes the same function in its kernel.
"""

from typing import Optional, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Word = Union[int, torch.Tensor]


def _rotl(x: Word, d: int) -> Word:
    return ((x << d) & MASK) | (x >> (32 - d))


def threefry2x32(k0: Word, k1: Word, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """Threefry-2x32 (20 rounds) of the counter ``(x0, x1)`` under the key ``(k0, k1)``.

    Each argument is a Python int or an int64 tensor of values in ``[0, 2**32)``
    (tensors broadcast); the two output words are of the same kind.
    """
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for step in range(5):
        for rot in _ROTATIONS[step % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, rot) ^ x0
        x0 = (x0 + ks[(step + 1) % 3]) & MASK
        x1 = (x1 + ks[(step + 2) % 3] + step + 1) & MASK
    return x0, x1


def as_words(key: torch.Tensor) -> torch.Tensor:
    """A key tensor (uint32 or any integer dtype) as int64 words in ``[0, 2**32)``."""
    if key.dtype == torch.uint32:
        key = key.view(torch.int32)
    return key.to(torch.int64) & MASK


def as_uint32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in ``[0, 2**32)`` as a ``torch.uint32`` tensor, the key leaf's dtype."""
    signed = words - ((words >> 31) << 32)  # [2**31, 2**32) to the negative int32 of the same bits
    return signed.to(torch.int32).view(torch.uint32)


def seed(value: int, device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(value)`` as a ``(2,)`` ``torch.uint32`` tensor: ``[0, value mod 2**32]``."""
    return as_uint32(torch.tensor([0, int(value) & MASK], dtype=torch.int64, device=device))


def split(key: torch.Tensor, num: Optional[int] = None) -> Union[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``jax.random.split(key)``: ``(new_key, subkey)``, each ``(..., 2)`` int64 words; with
    ``num``, ``jax.random.split(key, num)``: the ``(..., num, 2)`` keys, the i-th ``threefry(key, (0, i))``."""
    w = as_words(key)
    k0, k1 = w[..., 0:1], w[..., 1:2]
    counter = torch.arange(2 if num is None else num, dtype=torch.int64, device=w.device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(counter), counter)  # (..., n) each: counters 0 .. n - 1
    keys = torch.stack([y0, y1], -1)
    return (keys[..., 0, :], keys[..., 1, :]) if num is None else keys


def fold_in(key: torch.Tensor, data: Word) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: ``threefry(key, (0, data mod 2**32))``, int64 words.

    ``data`` is an int, or an integer tensor that folds each of its entries
    into the key (``vmap(lambda d: fold_in(key, d))``): ``(len(data), 2)``.
    """
    w = as_words(key)
    data = data.to(torch.int64) & MASK if isinstance(data, torch.Tensor) else int(data) & MASK
    y0, y1 = threefry2x32(w[..., 0], w[..., 1], 0, data)
    return torch.stack([y0, y1], -1)


def _bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` under the partitionable threefry: the XOR of
    the two output words of ``threefry(key, (0, i))`` for ``i < n``; ``(..., n)`` int64."""
    w = as_words(key)
    counter = torch.arange(n, dtype=torch.int64, device=w.device)
    y0, y1 = threefry2x32(w[..., 0:1], w[..., 1:2], torch.zeros_like(counter), counter)
    return y0 ^ y1


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` for ``(..., 2)`` keys: ``(..., n)`` int64 indices.

    JAX shuffles ``arange(n)`` by ``ceil(3 ln n / ln(2**32 - 1))`` rounds; each
    splits the key and sorts the positions stably by 32-bit bits drawn from the
    subkey.  The bits sort as int64, so their order stays unsigned.
    """
    w = as_words(key)
    perm = torch.arange(n, dtype=torch.int64, device=w.device).expand(*w.shape[:-1], n)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        w, sub = split(w)
        order = torch.sort(_bits(sub, n), dim=-1, stable=True).indices
        perm = torch.gather(perm, -1, order)
    return perm


def randint_bits(sub: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.randint(sub, (n,), 0, 2, int32)`` for a ``(..., 2)`` key: ``(..., n)`` int32 of 0 and 1."""
    _, k2 = split(sub)
    return (_bits(k2, n) & 1).to(torch.int32)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors rounded once to float32, as a fused multiply-add.

    The product of two float32 values is exact in float64; the sum is taken in
    float64 with its rounding error (TwoSum) and rounded to odd, from which
    the one rounding to float32 is the correctly rounded result.
    """
    a, b, c = (t.to(torch.float64) for t in torch.broadcast_tensors(a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")), torch.full_like(s, float("-inf")))
    # a NaN or infinite sum keeps its bits (a vectorized nextafter would drop a NaN's sign)
    s = torch.where((err != 0) & even & ~torch.isnan(err), torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def uniform(sub: torch.Tensor, m: int, minval: float, maxval: float) -> torch.Tensor:
    """``jax.random.uniform(sub, (m,), float32, minval, maxval)`` for a ``(2,)`` key: ``(m,)`` float32."""
    bits = _bits(sub, m).reshape(-1)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    span = torch.tensor(maxval, dtype=torch.float32, device=bits.device) - lo
    return torch.maximum(lo, fma32(floats, span, lo))
