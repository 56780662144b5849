"""Wall time of the Sync layer in a data-parallel step: the union of the port's ``metric.sync`` spans inside
the ``pb.step`` spans of rank 0's traced window (every member's batch-value sync: preflight, gathers and
reduce), over the steps.  ``None`` without the port's spans."""

from portbench.port_spans import covered, intersect


def read(r):
    if r.trace is None or not r.trace.spans("pb.step") or not r.trace.spans("metric.sync"):
        return None
    steps = r.trace.spans("pb.step")
    return covered(intersect(r.trace.spans("metric.sync"), steps)) / len(steps) / 1e6
