"""Device time of the update's generation statistics per 1,000 rows: the device operations launched inside
``update`` but outside the extractor (the sums and outer products folded into the states), over the rows."""


def read(r):
    if r.trace is None or not r.outcome.counts.get("rows"):
        return None
    ops = r.trace.ops_in("pb.update", outside="pb.extractor")
    if not ops:
        return None
    return r.trace.busy_ns(ops) / r.outcome.counts["rows"] * 1000 / 1e6
