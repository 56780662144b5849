"""The port's own spans in a traced window, and the split of the window by layer that they give.

While ``metrics_tpu_torch.obs`` is enabled and a profiler records, every span of the port is also a profiler
user annotation of its name: ``collection.forward``, ``metric.forward``, ``metric.update_impl`` (a member's
update body), ``metric.compute``, ``validation.check``, ``validation.format``, ``extractor.forward`` and the
rest.  :func:`reduce_events` keeps them as ranges beside the harness's ``pb.*`` ones (each name as the union
of its intervals, so a span nested in one of its own name counts once) and leaves the device operations and
host events exactly as :func:`portbench.tracing.reduce_events` gives them without the port's annotations:
their device-side copies are not operations.  :func:`readings` gives the per-layer numbers these spans give,
leaving out each whose spans are absent.

The harness does not use this module: its traced runs leave the port's spans off.  ``tools/port_span_probe.py``
runs a cell with them on.  Wiring them into the harness folds :func:`reduce_events` into
:func:`portbench.tracing.reduce_events` (``PERF.md``, section 7).
"""

from typing import Dict, Iterable, List, Optional, Sequence

from portbench import tracing
from portbench.tracing import BLOCKING_CALLS, DeviceOp, Interval, Trace, covered, merge

# the Validation layer's spans: value checks and the input case; the canonical one-hots and top-k
VALIDATION = ("validation.check", "validation.format")

# the cells each reading is defined for
SEG = ("cityscapes_seg.logits_b1",)
IMAGES = ("cifar10_fid.images_b50",)
FID = ("cifar10_fid.images_b50", "cifar10_fid.features_b50000")


def intersect(a: Sequence[Interval], b: Sequence[Interval]) -> List[Interval]:
    """The intersection of two unions, each given as sorted disjoint intervals."""
    out: List[Interval] = []
    i = j = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a: Sequence[Interval], b: Sequence[Interval]) -> List[Interval]:
    """``a`` less ``b``, each given as sorted disjoint intervals."""
    out: List[Interval] = []
    j = 0
    for lo, hi in a:
        while j < len(b) and b[j][1] <= lo:
            j += 1
        k, start = j, lo
        while k < len(b) and b[k][0] < hi:
            if b[k][0] > start:
                out.append((start, b[k][0]))
            start = max(start, b[k][1])
            k += 1
        if start < hi:
            out.append((start, hi))
    return out


def holds(intervals: Sequence[Interval], t: int) -> bool:
    """Whether ``t`` falls in one of the sorted disjoint ``intervals``."""
    return Trace({"": intervals}).inside("", t)


def is_host_read(op: DeviceOp) -> bool:
    """A copy from the card to the host (each ``.item()``, ``.tolist()`` or ``.cpu()`` is one), as
    ``seg.host_syncs_per_step`` counts them: a copy on the card is none."""
    return "DtoH" in op.name


# ------------------------------------------------------------------ the reduction


def reduce_events(events: Iterable) -> Trace:
    """A :class:`~portbench.tracing.Trace` of kineto events whose ranges also hold the port's spans: what
    :func:`portbench.tracing.reduce_events` gives for the same events without the port's annotations (and
    their device-side copies, which share their names), with the port's host-side annotations added as ranges."""
    events = list(events)
    port = [e for e in events if e.is_user_annotation() and not str(e.device_type()).endswith("CUDA")
            and not e.name().startswith("pb.")]
    names = {e.name() for e in port}
    trace = tracing.reduce_events(e for e in events if e.name() not in names)
    spans: Dict[str, List[Interval]] = {}
    for e in port:
        spans.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    trace.ranges.update({name: merge(v) for name, v in spans.items()})
    return trace


# ------------------------------------------------------------------ queries of a reduced trace


def union(trace: Trace, names: Iterable[str]) -> List[Interval]:
    return merge(iv for n in names for iv in trace.spans(n))


def _region(trace: Trace, names: Iterable[str], within: Optional[str]) -> List[Interval]:
    region = union(trace, names)
    return intersect(region, trace.spans(within)) if within else region


def count_in(trace: Trace, name: str, inside: Iterable[str], within: Optional[str] = None) -> int:
    """Spans ``name`` that start inside the spans ``inside`` (and inside the spans ``within``)."""
    region = _region(trace, inside, within)
    return sum(holds(region, a) for a, _ in trace.spans(name))


def launched_in(trace: Trace, names: Iterable[str], outside: Iterable[str] = (),
                within: Optional[str] = None) -> List[DeviceOp]:
    """Device operations launched inside a span of ``names`` (and inside the spans ``within``), and not
    inside a span of ``outside``."""
    region, away = _region(trace, names, within), union(trace, outside)
    return [op for op in trace.device if holds(region, op.launch) and not holds(away, op.launch)]


def self_host_ns(trace: Trace, names: Iterable[str], children: Iterable[str] = (),
                 within: Optional[str] = None) -> int:
    """Self host time of the spans ``names``: the union of their intervals (clipped to the spans
    ``within``), less the union of the spans ``children`` inside them, less the blocking runtime calls
    (:data:`~portbench.tracing.BLOCKING_CALLS`) inside what is left."""
    own = subtract(_region(trace, names, within), union(trace, children))
    blocked = merge((a, b) for a, b, n in trace.host if n in BLOCKING_CALLS)
    return covered(own) - covered(intersect(own, blocked))


def idle_gaps(trace: Trace) -> List[Interval]:
    """The window's stretches in which no operation ran on the card."""
    lo, hi = trace.window()
    return subtract([(lo, hi)], merge(tracing.clip([(op.start, op.end) for op in trace.device], lo, hi)))


def idle_in(trace: Trace, names: Iterable[str]) -> int:
    """Idle time of the window whose gaps' middles fall while the host is inside a span of ``names``."""
    region = union(trace, names)
    return sum(b - a for a, b in idle_gaps(trace) if holds(region, (a + b) // 2))


# ------------------------------------------------------------------ the per-layer readings


def _idle_share(trace: Trace, span: str) -> Optional[float]:
    """Share of the window's device-idle time whose gaps' middles fall while the host is inside ``span``."""
    idle = sum(b - a for a, b in idle_gaps(trace))
    if not trace.spans(span) or not idle:
        return None
    return 100.0 * idle_in(trace, [span]) / idle


def _pass_end_ms(trace: Trace) -> Optional[float]:
    """Device time of the ``collection.compute`` spans under ``pb.compute``, over their count."""
    passes = count_in(trace, "collection.compute", ["pb.compute"])
    if not passes:
        return None
    return trace.busy_ns(launched_in(trace, ["collection.compute"], (), "pb.compute")) / passes / 1e6


def readings(trace: Trace, cell: str) -> Dict[str, float]:
    """The per-layer numbers the port's spans give in cell ``cell`` (a step is a ``pb.step`` span of the
    window); a number whose spans the trace lacks, as without the port's spans, is left out."""
    out: Dict[str, float] = {}
    steps, s = len(trace.spans("pb.step")), "pb.step"
    if cell in SEG and steps:
        if trace.spans("collection.forward"):
            # the collection's own dispatch over its members, and the member update bodies it runs
            own = self_host_ns(trace, ["collection.forward"], ["metric.forward"], s)
            out["seg.collection_host_ms_per_step"] = own / steps / 1e6
            out["seg.member_updates_per_step"] = count_in(trace, "metric.update_impl", ["collection.forward"], s) / steps
        if trace.spans("metric.forward"):
            # state copies, merges and the batch value's compute, less the update bodies and Validation
            own = self_host_ns(trace, ["metric.forward"], ["metric.update_impl", *VALIDATION], s)
            out["seg.core_host_ms_per_step"] = own / steps / 1e6
        if union(trace, VALIDATION):
            ops = launched_in(trace, VALIDATION, (), s)
            out["seg.validation_host_ms_per_step"] = self_host_ns(trace, VALIDATION, (), s) / steps / 1e6
            out["seg.validation_syncs_per_step"] = sum(is_host_read(op) for op in ops) / steps
            out["seg.validation_device_ms_per_step"] = trace.busy_ns(ops) / steps / 1e6
        if trace.spans("metric.update_impl"):
            # the Engine: what the update bodies launch outside Validation
            ops = launched_in(trace, ["metric.update_impl"], VALIDATION, s)
            out["seg.engine_device_ms_per_step"] = trace.busy_ns(ops) / steps / 1e6
        compute = _pass_end_ms(trace)
        if compute is not None:
            out["seg.compute_ms"] = compute
    share = _idle_share(trace, "extractor.forward") if cell in IMAGES else None
    if share is not None:
        out["fid.extractor_idle_pct"] = share
    share = _idle_share(trace, "metric.compute") if cell in FID else None
    if share is not None:
        out["fid.compute_idle_pct"] = share
    return out
