"""RetrievalMetric base class (counterpart of ``metrics_tpu/retrieval/base.py``).

Subclasses score every query at once through one call into
:mod:`metrics_tpu_torch.functional.retrieval.engine` (``_group_scores``).  A
user subclass that only overrides the per-query ``_metric`` gets a default
``_group_scores`` that loops over the queries.
"""

from typing import Any, Optional, Tuple

import torch

from metrics_tpu_torch.functional.retrieval.engine import (
    contiguous_groups,
    group_relevant_counts,
    reduce_over_groups,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.checks import _check_retrieval_inputs

_EMPTY_TARGET_ACTIONS = ("error", "skip", "neg", "pos")


class RetrievalMetric(Metric):
    """Mean-over-queries retrieval metric on binary relevance targets.

    ``update`` takes ``preds``/``target``/``indexes`` of one shape; ``indexes``
    assigns every prediction to a query.  The rows go to three buffer states
    (int32 query ids, float32 scores, int32 or float32 targets).  ``compute``
    groups the rows by query, scores each query, applies
    ``empty_target_action`` to the queries with no positive target and takes
    the mean.

    Args:
        empty_target_action: ``'neg'`` (score 0), ``'pos'`` (score 1),
            ``'skip'`` (drop the query) or ``'error'`` (raise).
        ignore_index: drop the rows whose target equals this value.
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    stackable = False  # buffer states (indexes/preds/target) grow with the stream
    allow_non_binary_target = False
    _empty_kind = "positive"  # which missing target class makes a query "empty"

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if empty_target_action not in _EMPTY_TARGET_ACTIONS:
            raise ValueError(f"Argument `empty_target_action` received a wrong value `{empty_target_action}`.")
        self.empty_target_action = empty_target_action
        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError("Argument `ignore_index` must be an integer or None.")
        self.ignore_index = ignore_index
        self.add_buffer_state("indexes")
        self.add_buffer_state("preds")
        self.add_buffer_state("target")

    def update(self, preds: torch.Tensor, target: torch.Tensor, indexes: torch.Tensor) -> None:
        """Check, flatten and append the batch."""
        if indexes is None:
            raise ValueError("Argument `indexes` cannot be None")
        indexes, preds, target = _check_retrieval_inputs(
            indexes, preds, target,
            allow_non_binary_target=self.allow_non_binary_target,
            ignore_index=self.ignore_index,
        )
        self._buffer_append("indexes", indexes)
        self._buffer_append("preds", preds)
        self._buffer_append("target", target)

    def _grouped(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
        """The buffered scores and targets, and each row's query as ``0..n_groups-1``."""
        group, n_groups = contiguous_groups(self.buffer_values("indexes"))
        return self.buffer_values("preds"), self.buffer_values("target"), group, n_groups

    def compute(self) -> torch.Tensor:
        preds, target, group, n_groups = self._grouped()
        scores, empty = self._group_scores(preds, target, group, n_groups)
        return reduce_over_groups(scores, empty, self.empty_target_action, self._empty_kind)

    def _empty_mask(self, target: torch.Tensor, group: torch.Tensor, n_groups: int) -> torch.Tensor:
        """The queries with no positive target."""
        return group_relevant_counts(target, group, n_groups) == 0

    def _group_scores(
        self, preds: torch.Tensor, target: torch.Tensor, group: torch.Tensor, n_groups: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every query's score and the empty-query mask.

        The metrics of this package override this with one engine call; this
        default loops the queries through :meth:`_metric`, so a subclass that
        only writes ``_metric`` works.
        """
        scores = [self._metric(preds[group == gid], target[group == gid]) for gid in range(n_groups)]
        empty = self._empty_mask(target, group, n_groups)
        return (torch.stack(scores) if scores else torch.zeros((0,), device=preds.device)), empty

    def _metric(self, preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """One query's score; override where ``_group_scores`` is not overridden."""
        raise NotImplementedError
