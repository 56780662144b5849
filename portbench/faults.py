"""Faults planted under the timed path, each of which a run has to come out not correct with.

A fault is a function of a patcher (anything with ``setattr(target, name, value)``, as pytest's
``monkeypatch`` or :class:`Patch`) that breaks the program where it works: a step that leaves the state
unchanged, half of each batch left out, an answer altered where it is produced.  :data:`FAULTS` lists the
faults each kind of cell can have; every cell takes one card, so none leaves out an exchange between cards.
The CPU tests drive whole tiny runs under them; ``control.py --fault`` reads them at a cell's own size.
"""

from typing import Any, Callable, Dict, List, Tuple


class Patch:
    """``setattr`` that remembers what it replaced, undone by :meth:`undo`."""

    def __init__(self) -> None:
        self._saved: List[Tuple[Any, str, Any]] = []

    def setattr(self, target: Any, name: str, value: Any) -> None:
        self._saved.append((target, name, getattr(target, name)))
        setattr(target, name, value)

    def undo(self) -> None:
        while self._saved:
            target, name, value = self._saved.pop()
            setattr(target, name, value)


def seg_unchanged(patch) -> None:
    import metrics_tpu_torch as mt

    patch.setattr(mt.ConfusionMatrix, "update", lambda self, preds, target: None)
    patch.setattr(mt.Accuracy, "update", lambda self, preds, target: None)


def seg_half(patch) -> None:
    """The upper half of each image's rows (half of the batch's pixels) folded, the rest left out."""
    import metrics_tpu_torch as mt

    for cls in (mt.ConfusionMatrix, mt.Accuracy):
        original = cls.update

        def update(self, p, t, _o=original):
            return _o(self, p[..., : p.shape[-2] // 2, :], t[..., : t.shape[-2] // 2, :])

        patch.setattr(cls, "update", update)


def seg_miou_altered(patch) -> None:
    from metrics_tpu_torch.classification import jaccard as jaccard_module

    original = jaccard_module._jaccard_from_confmat
    patch.setattr(jaccard_module, "_jaccard_from_confmat", lambda *a, **k: original(*a, **k) * (1 + 1e-3))


def seg_count_altered(patch) -> None:
    import metrics_tpu_torch as mt

    original = mt.ConfusionMatrix.compute

    def compute(self):
        out = original(self).clone()
        out[0, 0] += 1
        return out

    patch.setattr(mt.ConfusionMatrix, "compute", compute)


def fid_unchanged(patch) -> None:
    import metrics_tpu_torch as mt

    patch.setattr(mt.FrechetInceptionDistance, "_ingest_chunk", lambda self, key, imgs: None)


def fid_half(patch) -> None:
    import metrics_tpu_torch as mt

    original = mt.FrechetInceptionDistance._ingest_chunk
    patch.setattr(mt.FrechetInceptionDistance, "_ingest_chunk",
                  lambda self, key, imgs: original(self, key, imgs[: len(imgs) // 2]))


def fid_value_altered(patch) -> None:
    from metrics_tpu_torch.image import fid as fid_module

    original = fid_module._compute_fid
    patch.setattr(fid_module, "_compute_fid", lambda *a: original(*a) * 1.01)


def fid_features_altered(patch) -> None:
    """One feature of each batch moved by a hundredth of the batch's largest, where the extractor makes it."""
    from metrics_tpu_torch.image.backbones.inception import InceptionFeatureExtractor

    original = InceptionFeatureExtractor.__call__

    def call(self, imgs):
        out = original(self, imgs).clone()
        out[0, 0] += 1e-2 * out.abs().max()
        return out

    patch.setattr(InceptionFeatureExtractor, "__call__", call)


# the faults each kind of cell can have, by (task, input): the images cell's FID value is not compared
# (PERF.md), so its altered answer is the feature the extractor produces
FAULTS: Dict[Tuple[str, str], Dict[str, Callable]] = {
    ("segmentation", "logits"): {"unchanged": seg_unchanged, "half": seg_half, "miou_altered": seg_miou_altered,
                                 "count_altered": seg_count_altered},
    ("fid", "images"): {"unchanged": fid_unchanged, "half": fid_half, "features_altered": fid_features_altered},
    ("fid", "features"): {"unchanged": fid_unchanged, "half": fid_half, "value_altered": fid_value_altered},
}


def faults_of(cell) -> Dict[str, Callable]:
    return FAULTS[(cell.config["task"], cell.traffic.get("input", "logits"))]
