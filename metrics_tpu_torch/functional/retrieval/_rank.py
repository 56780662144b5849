"""The stable descending order of one query's scores, as ``jnp.argsort(-preds)`` gives it."""

import torch

from metrics_tpu_torch.functional.classification.precision_recall_curve import _sort_keys


def _ranked_targets(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``target`` in the stable order of ``-preds`` (``-0.0`` equal to ``+0.0``, NaN last), as float32."""
    order = torch.sort(_sort_keys(-preds), stable=True).indices
    return target[order].to(torch.float32)


def _check_k(k) -> None:
    if k is not None and not (isinstance(k, int) and k > 0):
        raise ValueError("`k` has to be a positive integer or None")


def _where_relevant(n_rel: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``value`` where the query has a relevant document, else 0."""
    return torch.where(n_rel > 0, value, torch.zeros_like(value))
