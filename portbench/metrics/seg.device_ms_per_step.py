"""Device time of a segmentation step: the union of the intervals of the device operations launched
inside the steps, over the steps (the Engine and its kernels)."""


def read(r):
    steps = r.trace.spans("pb.step") if r.trace is not None else []
    ops = r.trace.ops_in("pb.step") if steps else []
    if not ops:
        return None
    return r.trace.busy_ns(ops) / len(steps) / 1e6
