"""Collectives in a data-parallel step: the port's ``sync.collective`` spans that start inside the
``pb.step`` spans of rank 0's traced window, over the steps.  ``None`` without the port's spans."""

from portbench.port_spans import count_in


def read(r):
    if r.trace is None or not r.trace.spans("pb.step") or not r.trace.spans("sync.collective"):
        return None
    return count_in(r.trace, "sync.collective", ["pb.step"]) / len(r.trace.spans("pb.step"))
