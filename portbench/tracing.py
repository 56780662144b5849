"""The benchmark's own spans and the reduction of a profiler trace to the numbers its readers take.

Spans are ``torch.profiler.record_function`` ranges that the harness opens around its calls into the
port (``pb.window``, ``pb.step``, ``pb.update``, ``pb.extractor``, ``pb.compute``); with tracing off they
are no-ops.  A device operation (kernel, copy or memset) belongs to the spans that were open on the host
when it was launched: its launch is the CUDA runtime call with the same correlation id, else the CPU
operator it is linked to, else its own start.
"""

import bisect
import contextlib
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[int, int]

# host calls during which the host waits for the card
BLOCKING_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy",
                  "cudaMemcpyAsync", "cudaMemcpy2D", "cudaMemcpy2DAsync", "cuStreamSynchronize",
                  "cuMemcpyDtoH", "cuMemcpyDtoHAsync")


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of intervals as sorted disjoint intervals."""
    out: List[List[int]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def covered(intervals: Sequence[Interval]) -> int:
    return sum(b - a for a, b in merge(intervals))


def clip(intervals: Iterable[Interval], lo: int, hi: int) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


@dataclass
class DeviceOp:
    name: str
    start: int
    end: int
    launch: int


@dataclass
class Trace:
    """A reduced trace: times in ns on the profiler's clock."""

    ranges: Dict[str, List[Interval]] = field(default_factory=dict)  # the harness's spans, sorted
    device: List[DeviceOp] = field(default_factory=list)
    host: List[Tuple[int, int, str]] = field(default_factory=list)  # operators and runtime calls, sorted

    def spans(self, name: str) -> List[Interval]:
        return self.ranges.get(name, [])

    def inside(self, name: str, t: int) -> bool:
        spans = self.spans(name)
        i = bisect.bisect_right(spans, (t, float("inf"))) - 1
        return i >= 0 and spans[i][0] <= t <= spans[i][1]

    def ops_in(self, name: str, outside: Optional[str] = None) -> List[DeviceOp]:
        """Device operations launched inside span ``name`` (and not inside span ``outside``)."""
        return [op for op in self.device
                if self.inside(name, op.launch) and not (outside and self.inside(outside, op.launch))]

    def busy_ns(self, ops: Iterable[DeviceOp]) -> int:
        return covered([(op.start, op.end) for op in ops])

    def window(self) -> Interval:
        spans = self.spans("pb.window")
        return (spans[0][0], spans[-1][1]) if spans else (0, 0)

    def window_busy_ns(self) -> int:
        lo, hi = self.window()
        return covered(clip([(op.start, op.end) for op in self.device], lo, hi))

    def host_calls_in(self, span: str, names: Sequence[str]) -> List[Tuple[int, int, str]]:
        return [h for h in self.host if h[2] in names and self.inside(span, h[0])]

    def breakdown(self, top: int = 10) -> Dict[str, List[List]]:
        """The device operations that took most time in the window, and the idle gaps summed by what
        the host was doing at each gap's middle (the innermost host event open there)."""
        lo, hi = self.window()
        by_name: Dict[str, int] = {}
        for op in self.device:
            if op.end > lo and op.start < hi:
                by_name[op.name] = by_name.get(op.name, 0) + min(op.end, hi) - max(op.start, lo)
        busy = merge(clip([(op.start, op.end) for op in self.device], lo, hi))
        gaps = [(a, b) for a, b in zip([lo] + [e for _, e in busy], [s for s, _ in busy] + [hi]) if b > a]
        gaps.sort(key=lambda g: g[0] - g[1])
        starts = [h[0] for h in self.host]
        by_host: Dict[str, int] = {}
        for a, b in gaps[:500]:
            mid = (a + b) // 2
            what = "nothing traced"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 2000, -1), -1):
                if self.host[j][1] >= mid:
                    what = self.host[j][2]
                    break
            span = next((n for n in ("pb.extractor", "pb.update", "pb.step", "pb.compute") if self.inside(n, mid)),
                        "pb.window")
            key = f"{span}: {what}"[:160]
            by_host[key] = by_host.get(key, 0) + b - a
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], t / 1e9] for n, t in ops], "idle_gaps": [[n, t / 1e9] for n, t in idle]}


def reduce_events(events: Iterable) -> Trace:
    """A :class:`Trace` from kineto events (``prof.profiler.kineto_results.events()``)."""
    ranges: Dict[str, List[Interval]] = {}
    host: List[Tuple[int, int, str]] = []
    runtime_start: Dict[int, int] = {}
    op_start: Dict[int, int] = {}
    raw_device = []
    for e in events:
        name, start = e.name(), e.start_ns()
        end = start + e.duration_ns()
        if str(e.device_type()).endswith("CUDA"):
            if name.startswith("pb."):  # the device-side copy of a span
                continue
            raw_device.append((name, start, end, e.correlation_id(), e.linked_correlation_id()))
        elif name.startswith("pb.") and e.is_user_annotation():
            ranges.setdefault(name, []).append((start, end))
        else:
            host.append((start, end, name))
            if name.startswith("cu"):  # CUDA runtime and driver calls
                runtime_start[e.correlation_id()] = start
            else:
                op_start[e.correlation_id()] = start
    device = []
    for name, start, end, corr, linked in raw_device:
        launch = runtime_start.get(corr, op_start.get(linked, start))
        device.append(DeviceOp(name, start, end, launch))
    device.sort(key=lambda op: op.start)
    host.sort()
    return Trace({k: sorted(v) for k, v in ranges.items()}, device, host)


class Tracer:
    """Spans around the harness's calls, and, when enabled, a profiler over the measured window."""

    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled
        self._prof = None
        self.trace: Optional[Trace] = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def start(self) -> None:
        if self.enabled:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()

    def stop(self) -> None:
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
            self.trace = reduce_events(self._prof.profiler.kineto_results.events())
            self._prof = None
