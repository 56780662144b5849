"""Plain confusion counts, IoU and class accuracies of per-pixel class scores.

The prediction of a pixel is the class of its largest score (the generated logits have one strict
maximum); the confusion matrix has rows for the labels and columns for the predictions.  Scores are
worked out in float64 from int64 counts.
"""

from typing import Dict

import torch


def confusion(logits: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """int64 ``(C, C)`` counts of ``(label, argmax of logits)`` over every pixel of the batch."""
    pred = logits.argmax(dim=1)
    idx = labels.reshape(-1) * num_classes + pred.reshape(-1)
    return torch.bincount(idx, minlength=num_classes * num_classes).reshape(num_classes, num_classes)


def jaccard(confmat: torch.Tensor, absent_score: float = 0.0) -> float:
    """Mean over classes of ``|pred ∩ label| / |pred ∪ label|``; a class absent from both scores ``absent_score``."""
    cm = confmat.to(torch.float64)
    inter = torch.diagonal(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    scores = torch.where(union == 0, torch.full_like(union, absent_score), inter / union.clamp(min=1))
    return float(scores.mean())


def pixel_accuracy(confmat: torch.Tensor) -> float:
    """Share of pixels whose prediction is their label."""
    cm = confmat.to(torch.float64)
    return float(torch.diagonal(cm).sum() / cm.sum())


def mean_class_accuracy(confmat: torch.Tensor) -> float:
    """Mean over classes of the share of a class's pixels predicted as it.  A class that is neither a label
    nor a prediction of any pixel is left out of the mean; one that is only predicted scores 0."""
    cm = confmat.to(torch.float64)
    hit = torch.diagonal(cm)
    labelled = cm.sum(1)
    seen = labelled + cm.sum(0) - hit > 0
    scores = torch.where(labelled == 0, torch.zeros_like(hit), hit / labelled.clamp(min=1))
    return float(scores[seen].mean())


def stat_counts(confmat: torch.Tensor, average: str = "micro") -> Dict[str, torch.Tensor]:
    """The one-hot counts of each class (``average="macro"``) or summed over the classes (``"micro"``),
    int64: true and false positives, false negatives, and true negatives (each pixel is a true negative
    for every class that is neither its label nor its prediction)."""
    cm = confmat.to(torch.int64)
    tp = torch.diagonal(cm)
    fp = cm.sum(0) - tp
    fn = cm.sum(1) - tp
    tn = cm.sum() - tp - fp - fn
    counts = {"tp": tp, "fp": fp, "fn": fn, "tn": tn}
    return counts if average == "macro" else {k: v.sum() for k, v in counts.items()}


def accuracy(confmat: torch.Tensor, average: str = "micro") -> float:
    return mean_class_accuracy(confmat) if average == "macro" else pixel_accuracy(confmat)
