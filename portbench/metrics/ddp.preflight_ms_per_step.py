"""Wall time of the sync preflight in a data-parallel step: the union of the port's ``sync.preflight`` spans
(the schema digests and the meta row exchanged before each state gather) inside the ``pb.step`` spans of
rank 0's traced window, over the steps.  ``None`` where the port has no such span."""

from portbench.port_spans import covered, intersect


def read(r):
    if r.trace is None or not r.trace.spans("pb.step") or not r.trace.spans("sync.preflight"):
        return None
    steps = r.trace.spans("pb.step")
    return covered(intersect(r.trace.spans("sync.preflight"), steps)) / len(steps) / 1e6
