"""Permutation invariant training (counterpart of ``metrics_tpu/functional/audio/pit.py``).

The speaker-pair metric matrix comes from one call of the metric over every
(prediction speaker, target speaker) pair stacked along the batch axis.  The
permutation search is exhaustive on the device up to
``_EXHAUSTIVE_SPK_LIMIT`` speakers (a gather over the permutation table and
an arg-max); above it, the exact assignment comes from the batched
Jonker-Volgenant solver on the host (:func:`metrics_tpu_torch._native.lap_batch`),
O(spk^3) instead of O(spk!).  The port never traces, so the JAX package's
traced limit has no counterpart.
"""

from itertools import permutations
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from metrics_tpu_torch.utils.checks import _as_tensor

_PERM_CACHE: Dict[int, np.ndarray] = {}

_EXHAUSTIVE_SPK_LIMIT = 6


def _perm_table(spk_num: int) -> np.ndarray:
    if spk_num not in _PERM_CACHE:
        _PERM_CACHE[spk_num] = np.asarray(list(permutations(range(spk_num))), dtype=np.int64)
    return _PERM_CACHE[spk_num]


def _pair_metric_matrix(preds: torch.Tensor, target: torch.Tensor, metric_func: Callable, **kwargs: Any) -> torch.Tensor:
    """``mtx[b, i, j] = metric_func(preds[:, i], target[:, j])[b]`` from one call over all pairs."""
    batch, spk = target.shape[:2]
    idx = torch.arange(spk, device=preds.device)
    pi = idx.repeat_interleave(spk)  # pair (i, j) at i * spk + j
    tj = idx.repeat(spk)
    p = preds[:, pi].transpose(0, 1).reshape((spk * spk * batch,) + tuple(preds.shape[2:]))
    t = target[:, tj].transpose(0, 1).reshape((spk * spk * batch,) + tuple(target.shape[2:]))
    values = metric_func(p, t, **kwargs)
    return values.reshape(spk, spk, batch).permute(2, 0, 1)


def permutation_invariant_training(
    preds: torch.Tensor, target: torch.Tensor, metric_func: Callable, eval_func: str = "max", **kwargs: Any
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The best metric over all speaker permutations, and that permutation.

    Args:
        preds: shape ``[batch, spk, ...]``
        target: shape ``[batch, spk, ...]``
        metric_func: a batched metric ``(preds[:, i], target[:, j]) -> [batch]``
            whose rows are independent
        eval_func: ``'max'`` (higher is better) or ``'min'``

    Returns:
        ``(best_metric [batch], best_perm [batch, spk])``; ``best_perm[b, s]``
        is the prediction that serves target speaker ``s`` (the contract of
        :func:`pit_permutate`).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional.audio.sdr import scale_invariant_signal_distortion_ratio
        >>> gen = torch.Generator().manual_seed(0)
        >>> preds, target = torch.randn(2, 2, 100, generator=gen), torch.randn(2, 2, 100, generator=gen)
        >>> best, perm = permutation_invariant_training(preds, target, scale_invariant_signal_distortion_ratio, 'max')
        >>> tuple(best.shape), tuple(perm.shape)
        ((2,), (2, 2))
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if eval_func not in ("max", "min"):
        raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
    if preds.ndim < 2 or target.ndim < 2 or target.shape[0] < 1:
        raise ValueError(f"Inputs must be of shape [batch, spk, ...], got {tuple(target.shape)} and {tuple(preds.shape)}")
    if preds.shape[:2] != target.shape[:2]:
        raise ValueError(
            f"Expected matching [batch, spk] leading dims, got {tuple(preds.shape)} and {tuple(target.shape)}"
        )
    spk_num = target.shape[1]
    metric_mtx = _pair_metric_matrix(preds, target, metric_func, **kwargs)
    if spk_num > _EXHAUSTIVE_SPK_LIMIT:
        return _pit_lap(metric_mtx, eval_func)

    perms = torch.as_tensor(_perm_table(spk_num), device=metric_mtx.device)  # [perm_num, spk]
    # the score of permutation p is the mean over target speakers s of
    # mtx[b, perms[p, s], s]: prediction perms[p, s] serves target s
    picked = metric_mtx[:, perms, torch.arange(spk_num, device=metric_mtx.device)]  # [batch, perm_num, spk]
    scores = picked.sum(-1) / torch.full((), spk_num, dtype=picked.dtype, device=picked.device)
    # the first best permutation wins a tie, as with ``jnp.argmax``
    best_idx = torch.argmax(scores, dim=1) if eval_func == "max" else torch.argmin(scores, dim=1)
    best_metric = scores.gather(1, best_idx[:, None])[:, 0]
    return best_metric, perms[best_idx].to(torch.int32)


def _pit_lap(metric_mtx: torch.Tensor, eval_func: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact assignment from the batched Jonker-Volgenant solver on the host (O(spk^3))."""
    from metrics_tpu_torch._native import lap_batch

    mtx = metric_mtx.detach().cpu().numpy()  # [batch, pred_spk, target_spk]
    # rows are target speakers and columns predictions: the solution maps a
    # target to its prediction (the pit_permutate contract)
    by_target = np.swapaxes(mtx, 1, 2)
    cost = np.ascontiguousarray(by_target, dtype=np.float64)
    if eval_func == "max":
        cost = -cost
    assign = lap_batch(cost)  # [batch, spk]
    picked = np.take_along_axis(by_target, assign[:, :, None], axis=2)[..., 0]
    best_metric = picked.mean(axis=-1)
    dev = metric_mtx.device
    return (
        torch.as_tensor(np.asarray(best_metric), dtype=metric_mtx.dtype, device=dev),
        torch.as_tensor(np.asarray(assign, dtype=np.int32), device=dev),
    )


def pit_permutate(preds: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Reorder ``preds`` by PIT's best permutation: speaker ``s`` of the
    output is ``preds[b, perm[b, s]]``, aligned with target speaker ``s``."""
    preds = _as_tensor(preds)
    perm = torch.as_tensor(perm, device=preds.device).long()
    idx = perm.reshape(tuple(perm.shape) + (1,) * (preds.ndim - 2))
    return torch.take_along_dim(preds, idx, dim=1)
