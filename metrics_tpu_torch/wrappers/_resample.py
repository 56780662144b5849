"""Bootstrap resample indices on the host (numpy only).

A copy of ``metrics_tpu/streaming/sketches.py::bootstrap_resample_indices``:
the same calls on the same ``np.random.Generator``, so a generator seeded
alike gives the JAX package's draws exactly.
"""

from typing import List, Union

import numpy as np


def bootstrap_resample_indices(
    rng: np.random.Generator,
    size: int,
    num_copies: int,
    sampling_strategy: str = "multinomial",
) -> Union[np.ndarray, List[np.ndarray]]:
    """Resample indices for all ``num_copies`` bootstrap copies in one generator draw.

    A ``Generator`` fills arrays row-major from one stream, so the draw equals
    ``num_copies`` sequential per-copy draws.  Returns a ``(num_copies, size)``
    index array for ``"multinomial"``; for ``"poisson"`` a list of per-copy
    index arrays of varying length (copy ``i`` repeats index ``j``
    ``counts[i, j]`` times).
    """
    if size < 1 or num_copies < 1:
        raise ValueError("size and num_copies must be positive")
    if sampling_strategy == "multinomial":
        return rng.integers(0, size, size=(num_copies, size))
    if sampling_strategy == "poisson":
        counts = rng.poisson(1.0, size=(num_copies, size))
        base = np.arange(size)
        return [np.repeat(base, counts[i]) for i in range(num_copies)]
    raise ValueError(f"unknown sampling strategy: {sampling_strategy!r}")


def stacked_poisson_draws(rng: np.random.Generator, size: int, num_copies: int):
    """The JAX package's poisson draws for copies it updates as one stacked state
    (``metrics_tpu/wrappers/bootstrapping.py:235-238``).

    By the splitting property of the Poisson process, a copy takes a total of
    ``N ~ Poisson(size)`` rows drawn uniformly.  Returns ``counts`` (int32,
    each capped at ``cap``) and an index array ``(num_copies, cap)``: copy
    ``i`` takes the rows ``idx[i, :counts[i]]``.
    """
    chunk = min(8, size)
    cap = size + 5 * int(np.ceil(np.sqrt(size))) + 10
    cap = ((cap + chunk - 1) // chunk) * chunk
    counts = np.minimum(rng.poisson(size, num_copies), cap).astype(np.int32)
    idx = rng.integers(0, size, size=(num_copies, cap))
    return counts, idx
