"""Wall time of the collectives in a data-parallel step: the union of the port's ``sync.collective`` spans
(each ``torch.distributed`` all-gather of ``DistBackend`` and its wait) inside the ``pb.step`` spans of rank
0's traced window, over the steps.  ``None`` without the port's spans."""

from portbench.port_spans import covered, intersect


def read(r):
    if r.trace is None or not r.trace.spans("pb.step") or not r.trace.spans("sync.collective"):
        return None
    steps = r.trace.spans("pb.step")
    return covered(intersect(r.trace.spans("sync.collective"), steps)) / len(steps) / 1e6
