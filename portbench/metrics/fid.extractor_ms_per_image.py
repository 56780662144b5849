"""Device time of the extractor per image: the union of the intervals of the device operations launched
inside the extractor's calls (resize, scaling, the Inception-v3 forward), over the images folded."""


def read(r):
    c = r.outcome.counts
    if r.trace is None or not c.get("input_images"):
        return None
    ops = r.trace.ops_in("pb.extractor")
    if not ops:
        return None
    return r.trace.busy_ns(ops) / c["rows"] / 1e6
