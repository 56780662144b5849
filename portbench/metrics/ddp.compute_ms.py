"""Wall time of a data-parallel pass end: the mean of rank 0's ``pb.compute`` spans (the synced
``compute()`` of every member, the pass score read on the host, the pass's answers queued to the host and
``reset()``) over the traced window."""


def read(r):
    spans = r.trace.spans("pb.compute") if r.trace is not None else []
    if not spans:
        return None
    return sum(b - a for a, b in spans) / len(spans) / 1e6
