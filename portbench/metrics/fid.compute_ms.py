"""Device time of a pass-end ``compute()`` (the two ``eigh`` of the Generation statistics and their
products): the union of the intervals of the device operations launched inside each ``pb.compute`` span,
summed over the traced window's passes and over their count."""


def read(r):
    spans = r.trace.spans("pb.compute") if r.trace is not None else []
    ops = r.trace.ops_in("pb.compute") if spans else []
    if not ops:
        return None
    return r.trace.busy_ns(ops) / len(spans) / 1e6
