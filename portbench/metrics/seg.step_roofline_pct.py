"""A segmentation step's share of its memory roofline: the least time the bytes the step needs take at the
card's HBM rate, over the device time of the window's steps.

The bytes are the same whatever implements the step: the logits read once, the labels read once, and each
member's states read and written once (int32 counts: a ``(C, C)`` confusion matrix for a Jaccard index or
a confusion matrix; for an accuracy four stat scores, per class under ``average="macro"``, and two scalars)."""


def _accuracy_bytes(c: int, kwargs) -> int:
    per_class = kwargs.get("average", "micro") == "macro"
    return 4 * (4 * (c if per_class else 1) + 2)


STATE_BYTES = {"JaccardIndex": lambda c, kw: 4 * c * c, "ConfusionMatrix": lambda c, kw: 4 * c * c,
               "Accuracy": _accuracy_bytes}


def state_bytes(classes: int, members) -> int:
    """Bytes of the members' states; ``members`` are the configuration's ``{"class", "kwargs"}`` entries."""
    return sum(STATE_BYTES[m["class"]](classes, m["kwargs"]) for m in members)


def step_bytes(images: int, classes: int, height: int, width: int, members, logit_bytes: int = 4,
               label_bytes: int = 8) -> int:
    pixels = images * height * width
    return pixels * classes * logit_bytes + pixels * label_bytes + 2 * state_bytes(classes, members)


def read(r):
    steps = r.trace.spans("pb.step") if r.trace is not None else []
    ops = r.trace.ops_in("pb.step") if steps else []
    if not ops:
        return None
    c = r.outcome.counts
    members = r.cell.config["metrics"]
    # every step of the traced window: its images' pixels (a pass's short last step has fewer), and the
    # states once a step
    need = step_bytes(int(c["images"]), int(c["num_classes"]), int(c["height"]), int(c["width"]), members)
    need += (len(steps) - 1) * 2 * state_bytes(int(c["num_classes"]), members)
    least_ns = need / r.peaks["hbm_bytes_per_s"] * 1e9
    return 100.0 * least_ns / r.trace.busy_ns(ops)
