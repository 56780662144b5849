"""The reduction of profiler events: spans, launch attribution, unions of device time, idle share."""

from portbench.tracing import BLOCKING_CALLS, merge, reduce_events


class Event:
    def __init__(self, name, start, dur, device=False, corr=0, linked=0, annotation=False):
        self._v = (name, start, dur, "DeviceType.CUDA" if device else "DeviceType.CPU", corr, linked, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def _trace():
    return reduce_events([
        Event("pb.window", 0, 1000, annotation=True),
        Event("pb.step", 0, 400, annotation=True),
        Event("pb.step", 500, 400, annotation=True),
        Event("pb.step", 500, 400, device=True),  # the span's device-side copy: not an operation
        Event("aten::argmax", 10, 50, corr=1),
        Event("cudaLaunchKernel", 20, 5, corr=101),
        Event("argmax_kernel", 100, 100, device=True, corr=101, linked=1),
        Event("aten::copy_", 510, 80, corr=2),
        Event("copy_kernel", 520, 60, device=True, corr=0, linked=2),  # no runtime event: its operator's start
        Event("Memcpy DtoH (Device -> Pageable)", 600, 20, device=True, corr=102),
        Event("cudaMemcpyAsync", 590, 40, corr=102),
        Event("cudaStreamSynchronize", 630, 30, corr=103),
        Event("late_kernel", 950, 100, device=True, corr=104),  # launched outside every step, runs past the window
    ])


def test_spans_and_launches():
    t = _trace()
    assert t.spans("pb.step") == [(0, 400), (500, 900)] and t.window() == (0, 1000)
    assert {op.name: op.launch for op in t.device} == {
        "argmax_kernel": 20, "copy_kernel": 510, "Memcpy DtoH (Device -> Pageable)": 590, "late_kernel": 950}
    assert sorted(op.name for op in t.ops_in("pb.step")) == ["Memcpy DtoH (Device -> Pageable)", "argmax_kernel",
                                                             "copy_kernel"]


def test_busy_idle_and_blocked_time():
    t = _trace()
    assert merge([(0, 5), (3, 8), (10, 12)]) == [(0, 8), (10, 12)]
    assert t.busy_ns(t.ops_in("pb.step")) == 100 + 60 + 20
    assert t.window_busy_ns() == 100 + 60 + 20 + 50  # the late kernel counts up to the window's end
    blocked = t.host_calls_in("pb.step", BLOCKING_CALLS)
    assert sorted(h[2] for h in blocked) == ["cudaMemcpyAsync", "cudaStreamSynchronize"]
    b = t.breakdown()
    assert b["device_ops"][0] == ["argmax_kernel", 100e-9]
    assert abs(sum(s for _, s in b["idle_gaps"]) - (1000 - 230) / 1e9) < 1e-15
