"""Host time of a segmentation step: the step's wall time less the time the host sat blocked on the card
(synchronisations and copies, as the profiler records the runtime calls), averaged over the window's steps.
It reads the Collection, Metric core and Validation layers: Python dispatch, checks and launches."""

from portbench.tracing import BLOCKING_CALLS


def read(r):
    if r.trace is None or not r.trace.spans("pb.step"):
        return None
    steps = r.trace.spans("pb.step")
    wall = sum(b - a for a, b in steps)
    blocked = sum(end - start for start, end, _ in r.trace.host_calls_in("pb.step", BLOCKING_CALLS))
    return (wall - blocked) / len(steps) / 1e6
