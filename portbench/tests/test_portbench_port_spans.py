"""The port's own spans in a traced window (``portbench/port_spans.py``): the reduction that keeps them
beside the harness's spans without moving any existing reading, the interval arithmetic, self host time,
idle attribution, the per-layer readings, and tiny whole CPU runs of each cell with the spans on (through
``tools/port_span_probe.py``'s tracer, with its step split and idle split by span)."""

import time

import pytest

from metrics_tpu_torch import obs
from portbench import harness, port_spans, tracing
from portbench.cell import Cell
from portbench.harness import Outcome, Reading, run
from portbench.port_spans import (count_in, holds, idle_gaps, idle_in, intersect, is_host_read, readings,
                                  self_host_ns, subtract)
from portbench.tracing import DeviceOp
from portbench.tests._tiny import bench
from portbench.tests.test_portbench_tracing import Event, _trace
from tools.port_span_probe import PortTracer, idle_by_span, port_span_names, step_split

SEG, IMAGES = "cityscapes_seg.logits_b1", "cifar10_fid.images_b50"
READINGS = ("seg.collection_host_ms_per_step", "seg.member_updates_per_step", "seg.core_host_ms_per_step",
            "seg.validation_host_ms_per_step", "seg.validation_syncs_per_step",
            "seg.validation_device_ms_per_step", "seg.engine_device_ms_per_step", "seg.compute_ms",
            "fid.extractor_idle_pct", "fid.compute_idle_pct")


def _harness_events():
    return [
        Event("pb.window", 0, 1000, annotation=True),
        Event("pb.step", 0, 400, annotation=True),
        Event("pb.step", 500, 400, annotation=True),
        Event("pb.step", 500, 400, device=True),
        Event("aten::argmax", 10, 50, corr=1),
        Event("cudaLaunchKernel", 20, 5, corr=101),
        Event("argmax_kernel", 100, 100, device=True, corr=101, linked=1),
        Event("aten::copy_", 510, 80, corr=2),
        Event("copy_kernel", 520, 60, device=True, corr=0, linked=2),
        Event("Memcpy DtoH (Device -> Pageable)", 600, 20, device=True, corr=102),
        Event("cudaMemcpyAsync", 590, 40, corr=102),
        Event("cudaStreamSynchronize", 630, 30, corr=103),
        Event("late_kernel", 950, 100, device=True, corr=104),
    ]


def _port_events():
    """Two steps: a collection forward over two members (the first validating before its update body, as
    ``Accuracy`` locks its input case), a host read inside Validation and a sync inside the batch value's
    compute; then a pass end.  Each port span also has its device-side copy."""
    spans = [("collection.forward", 10, 380), ("metric.forward", 20, 180), ("validation.check", 25, 35),
             ("metric.update_impl", 40, 140), ("validation.check", 45, 65), ("validation.format", 70, 100),
             ("metric.compute", 150, 175), ("metric.sync", 155, 160), ("metric.forward", 200, 370),
             ("metric.update_impl", 210, 330), ("validation.format", 215, 225), ("metric.compute", 340, 360),
             ("collection.forward", 510, 880), ("metric.forward", 520, 870), ("metric.update_impl", 530, 860),
             ("collection.compute", 905, 990), ("metric.compute", 910, 980)]
    events = [Event(n, a, b - a, annotation=True) for n, a, b in spans]
    events += [Event(n, a + 1, b - a - 2, device=True) for n, a, b in spans]  # device-side copies
    events += [Event("pb.compute", 900, 95, annotation=True),
               Event("cudaLaunchKernel", 75, 2, corr=201), Event("onehot_kernel", 300, 30, device=True, corr=201),
               Event("cudaLaunchKernel", 120, 2, corr=202), Event("count_kernel", 330, 40, device=True, corr=202),
               Event("cudaMemcpyAsync", 50, 10, corr=203),
               Event("Memcpy DtoH (Device -> Pageable)", 335, 5, device=True, corr=203),
               Event("cudaStreamSynchronize", 165, 8, corr=204),
               Event("cudaLaunchKernel", 915, 2, corr=205), Event("eigh_kernel", 920, 50, device=True, corr=205)]
    return events


def _without_port_spans(events):
    """``events`` less the port's annotations and their device-side copies: what a program without the
    port's spans records."""
    port = {e.name() for e in events if e.is_user_annotation() and not e.name().startswith("pb.")}
    return [e for e in events if e.name() not in port]


def _reading(trace, cell):
    out = Outcome(setup_s=0.0, end_to_end={}, counts={"images": 2, "height": 4, "width": 4, "num_classes": 3,
                                                      "rows": 100, "input_images": 1},
                  memory_peak_bytes=0, checks=[], attempted=0, failed=0)
    return Reading(trace, out, Cell(cell), {"hbm_bytes_per_s": 1e12, "fp32_flops_per_s": 1e12})


def _existing_readings(trace, cell):
    c = Cell(cell)
    return {m["name"]: c.reader(m["name"])(_reading(trace, cell)) for m in c.per_layer()}


def _host_ms_per_step(trace):
    return Cell(SEG).reader("seg.host_ms_per_step")(_reading(trace, SEG))


def test_port_spans_leave_every_existing_reading_unchanged():
    events = _harness_events() + _port_events()
    plain, spanned = tracing.reduce_events(_without_port_spans(events)), port_spans.reduce_events(events)
    assert spanned.device == plain.device and spanned.host == plain.host
    assert spanned.breakdown() == plain.breakdown()
    assert {k: v for k, v in spanned.ranges.items() if k.startswith("pb.")} == plain.ranges
    assert port_span_names(spanned) == ["collection.compute", "collection.forward", "metric.compute",
                                              "metric.forward", "metric.sync", "metric.update_impl",
                                              "validation.check", "validation.format"]
    for cell in (SEG, IMAGES, "cifar10_fid.features_b50000"):
        assert _existing_readings(spanned, cell) == _existing_readings(plain, cell)
    # no device-side copy of a span counts as an operation
    assert {op.name for op in spanned.device} == {"argmax_kernel", "copy_kernel", "late_kernel", "onehot_kernel",
                                                  "count_kernel", "Memcpy DtoH (Device -> Pageable)", "eigh_kernel"}


def test_the_harness_reduction_would_count_the_copies_as_operations():
    # why the port's spans need their own reduction: the harness's drops only the pb.* copies
    t = tracing.reduce_events(_harness_events() + _port_events())
    assert "metric.forward" in {op.name for op in t.device}


def test_nested_spans_of_one_name_count_once():
    t = port_spans.reduce_events([Event("pb.window", 0, 100, annotation=True),
                                  Event("metric.compute", 10, 50, annotation=True),
                                  Event("metric.compute", 20, 10, annotation=True),
                                  Event("metric.compute", 70, 10, annotation=True)])
    assert t.spans("metric.compute") == [(10, 60), (70, 80)]
    assert self_host_ns(t, ["metric.compute"]) == 60


def test_interval_arithmetic():
    assert intersect([(0, 10), (20, 30)], [(5, 25)]) == [(5, 10), (20, 25)]
    assert subtract([(0, 10), (20, 30)], [(2, 4), (8, 22), (29, 40)]) == [(0, 2), (4, 8), (22, 29)]
    assert subtract([(0, 10)], []) == [(0, 10)] and intersect([], [(0, 1)]) == []
    assert holds([(0, 10), (20, 30)], 20) and not holds([(0, 10), (20, 30)], 15)


def test_a_copy_on_the_card_is_not_a_read():
    assert is_host_read(DeviceOp("Memcpy DtoH (Device -> Pageable)", 0, 1, 0))
    assert is_host_read(DeviceOp("Memcpy DtoH (Device -> Pinned)", 0, 1, 0))
    assert not is_host_read(DeviceOp("Memcpy DtoD (Device -> Device)", 0, 1, 0))
    assert not is_host_read(DeviceOp("Memcpy HtoD (Pageable -> Device)", 0, 1, 0))


def test_self_host_time_partitions_a_step():
    t = port_spans.reduce_events(_harness_events() + _port_events())
    steps = len(t.spans("pb.step"))
    split = step_split(t)["host_ms"]
    assert sum(split.values()) * steps == pytest.approx(_host_ms_per_step(t) * steps, abs=1e-12)
    # by hand: the read inside Validation (50-60) and the sync inside the batch value's compute (165-173)
    assert split["validation"] * steps * 1e6 == pytest.approx(10 + 20 + 30 + 10 - 10)
    assert split["core"] * steps * 1e6 == pytest.approx((5 + 5 + 40 - 8) + (10 + 40) + (10 + 10))
    assert split["collection"] * steps * 1e6 == pytest.approx((10 + 20 + 10) + (10 + 10))
    got = readings(t, SEG)
    assert got["seg.collection_host_ms_per_step"] == split["collection"]
    assert got["seg.core_host_ms_per_step"] == split["core"]
    assert got["seg.validation_host_ms_per_step"] == split["validation"]


def test_readings_on_the_synthetic_trace():
    t = port_spans.reduce_events(_harness_events() + _port_events())
    got = readings(t, SEG)
    assert set(got) == {n for n in READINGS if n.startswith("seg.")}
    assert got["seg.member_updates_per_step"] == 3 / 2
    assert got["seg.validation_syncs_per_step"] == 1 / 2
    assert got["seg.validation_device_ms_per_step"] == (30 + 5) / 2 / 1e6  # the one-hots and the read
    # the count kernel and the second step's read (launched at 590, inside its update body), not the one-hots
    assert got["seg.engine_device_ms_per_step"] == (40 + 20) / 2 / 1e6
    # the eigh kernel (920-970) and the late kernel, launched at 950 inside the compute (950-1050)
    assert got["seg.compute_ms"] == (1050 - 920) / 1e6
    assert count_in(t, "metric.update_impl", ["collection.forward"], "pb.step") == 3
    split = step_split(t)
    assert split["reads"]["validation"] == 1 / 2 and split["reads"]["update_body_outside_validation"] == 1 / 2
    # the gap 970-1000 has its middle inside pb.compute, after metric.compute's end (980): not the compute's
    assert idle_in(t, ["metric.compute"]) == 0 and readings(t, IMAGES)["fid.compute_idle_pct"] == 0.0


def test_idle_gaps_go_to_the_innermost_port_span():
    t = port_spans.reduce_events([
        Event("pb.window", 0, 1000, annotation=True),
        Event("metric.update_impl", 0, 600, annotation=True),
        Event("extractor.forward", 100, 300, annotation=True),
        Event("metric.compute", 700, 200, annotation=True),
        Event("metric.sync", 720, 20, annotation=True),
        Event("k1", 0, 50, device=True), Event("k2", 150, 150, device=True), Event("k3", 340, 10, device=True),
        Event("k4", 600, 100, device=True), Event("k5", 760, 230, device=True),
    ])
    # gaps: 50-150 (middle 100: extractor.forward, started last), 300-340 (320: extractor.forward),
    # 350-600 (475: metric.update_impl), 700-760 (730: metric.sync), 990-1000 (995: none)
    assert idle_gaps(t) == [(50, 150), (300, 340), (350, 600), (700, 760), (990, 1000)]
    assert idle_by_span(t) == {"extractor.forward": 140, "metric.update_impl": 250, "metric.sync": 60, "": 10}
    assert idle_in(t, ["metric.compute"]) == 60 and idle_in(t, ["extractor.forward"]) == 140
    assert readings(t, IMAGES) == {"fid.extractor_idle_pct": 100.0 * 140 / 460, "fid.compute_idle_pct": 100.0 * 60 / 460}
    assert readings(t, "cifar10_fid.features_b50000") == {"fid.compute_idle_pct": 100.0 * 60 / 460}


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_no_reading_without_the_port_spans(cell):
    assert readings(_trace(), cell) == {}
    assert readings(port_spans.reduce_events(_harness_events()), cell) == {}


def _tiny(name):
    """A tiny version of cell ``name``; a segmentation pass is one step, so every window holds a pass end."""
    cell = Cell(name)
    if name.startswith("cityscapes_seg"):
        cell.config.update(height=32, width=64, label_block=4, images_per_pass=4)
        cell.traffic.update(batch=4, pool_batches=2)
    elif name.endswith("images_b50"):
        cell.traffic.update(batch=2, real_per_pass=2, fake_per_pass=2)
    else:
        cell.config["feature"] = 64
        cell.traffic.update(batch=50, real_per_pass=200, fake_per_pass=200)
    return cell


class _KeepEvents:
    """``port_spans.reduce_events`` keeping the raw events of each trace it reduces."""

    def __init__(self):
        self.kept = []

    def __call__(self, events):
        self.kept.append(list(events))
        return _REDUCE(self.kept[-1])


_REDUCE = port_spans.reduce_events


@pytest.mark.parametrize("name", [w["name"] for w in bench()["workloads"]])
def test_a_tiny_traced_run_of_each_cell_gives_every_reading(monkeypatch, name):
    keep = _KeepEvents()
    monkeypatch.setattr(port_spans, "reduce_events", keep)
    monkeypatch.setattr(harness, "Tracer", PortTracer)
    # an images pass is two Inception forwards at 299 x 299: the window leaves room for them on a loaded CPU
    seconds = 5.0 if name == IMAGES else 1.0
    result = run(_tiny(name), 2**31 + 77, seconds, True, "cpu", time.perf_counter())
    assert result["correct"] and not obs.enabled()
    events = keep.kept[-1]
    spanned, plain = _REDUCE(events), tracing.reduce_events(_without_port_spans(events))
    want = {"cityscapes_seg.logits_b1": {n for n in READINGS if n.startswith("seg.")},
            "cifar10_fid.images_b50": {"fid.extractor_idle_pct", "fid.compute_idle_pct"},
            "cifar10_fid.features_b50000": {"fid.compute_idle_pct"}}[name]
    assert set(readings(spanned, name)) == want
    if name == SEG:
        assert readings(spanned, name)["seg.member_updates_per_step"] == 3.0
        names = set(port_span_names(spanned))
        assert {"collection.forward", "metric.forward", "metric.update_impl", "metric.compute", "validation.check",
                "collection.compute"} <= names
        # (N, C, X) float logits go to the stat-scores kernel's plane entry: no canonical formatting on the route
        assert "validation.format" not in names
        steps = len(spanned.spans("pb.step"))
        parts = sum(step_split(spanned)["host_ms"].values())
        assert parts * steps == pytest.approx(_host_ms_per_step(spanned) * steps, rel=1e-12)
    elif name == IMAGES:
        assert "extractor.forward" in port_span_names(spanned)
    # the same events without the port's annotations: every existing reading as it was
    assert plain.device == spanned.device and plain.host == spanned.host
    assert plain.breakdown() == spanned.breakdown()
    assert _existing_readings(plain, name) == _existing_readings(spanned, name)


def test_the_harness_tracer_leaves_the_port_spans_off(monkeypatch):
    tracers = []

    class Kept(tracing.Tracer):
        def __init__(self, enabled):
            super().__init__(enabled)
            tracers.append(self)

    monkeypatch.setattr(harness, "Tracer", Kept)
    result = run(_tiny(SEG), 2**31 + 78, 0.3, True, "cpu", time.perf_counter())
    assert result["correct"] and not obs.enabled()
    host_names = {name for _, _, name in tracers[-1].trace.host}
    assert not host_names & {"collection.forward", "metric.forward", "metric.update_impl", "validation.check"}
