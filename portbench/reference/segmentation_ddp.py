"""Plain answers of data-parallel segmentation: the int64 confusion counts of each rank's own images, summed
over the ranks with plain ``torch.distributed`` calls, and the scores of those sums.

A step's answers are those of the confusion of every rank's batch at that step, summed; a pass's answers
those of the sum over the pass's images on every rank; a rank's own states those of its own images.  The
counts and scores are :mod:`portbench.reference.segmentation`'s.
"""

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from portbench.reference import segmentation as ref

Key = Tuple[int, int]  # (pool batch, images)


def rank_confusions(logits: Sequence[torch.Tensor], labels: Sequence[torch.Tensor], keys: Sequence[Key],
                    num_classes: int) -> torch.Tensor:
    """int64 ``(K, C, C)``: the confusion of this rank's first ``n`` images of pool batch ``p``, for each
    ``(p, n)`` of ``keys``, on the device of the pool."""
    return torch.stack([ref.confusion(logits[p][:n], labels[p][:n], num_classes) for p, n in keys])


def gather_ranks(local: torch.Tensor, wire: torch.device) -> torch.Tensor:
    """Every rank's ``local`` stacked in rank order, ``(P,) + local.shape``, on the CPU: one plain
    ``torch.distributed.all_gather`` over the default group, through ``wire`` (a CUDA device under NCCL)."""
    moved = local.contiguous().to(wire)
    parts: List[torch.Tensor] = [torch.empty_like(moved) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, moved)
    return torch.stack(parts).cpu()


def answers(confmat: torch.Tensor, average: str) -> Dict[str, object]:
    """The collection's three answers from int64 confusion counts, by member class."""
    return {"JaccardIndex": ref.jaccard(confmat), "Accuracy": ref.accuracy(confmat, average),
            "ConfusionMatrix": confmat}
