"""Bytes the sync gathers a data-parallel step, in KiB: the change of the port's ``sync.bytes_gathered`` and
``sync.preflight_bytes`` counters over rank 0's window (the steps' syncs and the pass ends'), over the
window's steps.  The task reads the counters; ``None`` where it did not."""


def read(r):
    counts = r.outcome.counts
    if "sync_bytes" not in counts or not counts.get("steps"):
        return None
    return counts["sync_bytes"] / counts["steps"] / 1024
