"""The stat-scores kernel's plain version and wrapper against the JAX package.

On the CPU the port's :func:`fused_stat_scores` takes its plain version; it is
held bitwise against the Pallas kernel in interpret mode (as
``tests/test_pallas_ops.py`` runs it) and, above the Pallas kernel's class
cap, against the JAX package's jnp reductions.  The CUDA kernel itself is
compared with the plain version on the card by ``tests/test_torch_cuda.py``
and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.functional.classification.stat_scores import _stat_scores as jax_stat_scores
from metrics_tpu.ops import fused_stat_scores as pallas_stat_scores
from metrics_tpu_torch.functional.classification.stat_scores import _stat_scores
from metrics_tpu_torch.ops import stat_scores as ops


def _operands(n, c, dtype, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, (n, c)).astype(dtype), rng.integers(0, 2, (n, c)).astype(dtype)


def _assert_counts_equal(got, expected):
    assert len(got) == len(expected) == 4
    for g, e in zip(got, expected):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


@pytest.mark.parametrize("dtype", [np.int32, np.bool_])
@pytest.mark.parametrize("n,c", [(512, 8), (1000, 5), (3, 7), (0, 4)])
def test_plain_matches_pallas_interpret(n, c, dtype):
    p, t = _operands(n, c, dtype, seed=n + c)
    expected = pallas_stat_scores(jnp.asarray(p, jnp.int32), jnp.asarray(t, jnp.int32), interpret=True)
    _assert_counts_equal(ops.fused_stat_scores_plain(torch.from_numpy(p), torch.from_numpy(t)), expected)


def test_plain_matches_jnp_above_pallas_class_cap():
    p, t = _operands(70, 1030, np.int32, seed=1)
    expected = jax_stat_scores(jnp.asarray(p), jnp.asarray(t), reduce="macro")
    _assert_counts_equal(ops.fused_stat_scores_plain(torch.from_numpy(p), torch.from_numpy(t)), expected)


@pytest.mark.parametrize("reduce", ["micro", "macro", "samples"])
@pytest.mark.parametrize("shape", [(40, 6), (10, 4, 3)])
def test_stat_scores_engine_matches_jnp(reduce, shape):
    rng = np.random.default_rng(2)
    p = rng.integers(0, 2, shape).astype(np.int32)
    t = rng.integers(0, 2, shape).astype(np.int32)
    expected = jax_stat_scores(jnp.asarray(p), jnp.asarray(t), reduce=reduce)
    _assert_counts_equal(_stat_scores(torch.from_numpy(p), torch.from_numpy(t), reduce=reduce), expected)


def test_wrapper_takes_plain_path_on_cpu_and_counts_no_launch():
    p, t = _operands(37, 9, np.int32, seed=3)
    before = ops.fused_stat_scores.launches
    got = ops.fused_stat_scores(torch.from_numpy(p), torch.from_numpy(t))
    _assert_counts_equal(got, ops.fused_stat_scores_plain(torch.from_numpy(p), torch.from_numpy(t)))
    assert ops.fused_stat_scores.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    p = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.fused_stat_scores(p.long(), p.long())
    with pytest.raises(TypeError):
        ops.fused_stat_scores(p, p.bool())
    with pytest.raises(ValueError):
        ops.fused_stat_scores(p, p[:4])
    with pytest.raises(ValueError):
        ops.fused_stat_scores(p[:, :1].reshape(8), p[:, :1].reshape(8))
    with pytest.raises(ValueError):
        ops.fused_stat_scores(p.t(), p.t())
    with pytest.raises(ValueError):
        ops.fused_stat_scores(p, torch.zeros((8, 4), dtype=torch.int32, device="meta"))
