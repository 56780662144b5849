"""Share of the traced window of an FID cell in which no operation ran on the card."""


def read(r):
    if r.trace is None:
        return None
    lo, hi = r.trace.window()
    if hi <= lo or not r.trace.device:
        return None
    return 100.0 * (1.0 - r.trace.window_busy_ns() / (hi - lo))
