"""The port's spans in a ``torch.profiler`` trace (``metrics_tpu_torch.obs``).

While obs is enabled and a profiler records, every span also opens a user
annotation of its name, so the trace nests ``collection.forward`` over the
members' ``metric.forward``, each over its update body
(``metric.update_impl``), which holds the Validation spans
(``validation.check``, and ``validation.format`` where the inputs are
canonicalised: segmentation logits ``(N, C, H, W)`` are counted straight from
the logits, without it) and, for the image metrics, the extractor's call
(``extractor.forward``).  Disabled, no span site reaches the
profiler; enabled without a profiler, the in-memory aggregates are kept as
before and no annotation is opened.
"""

import pytest
import torch

import metrics_tpu_torch as mt
from metrics_tpu_torch import obs
from metrics_tpu_torch.obs import core as obs_core

C, H, W = 19, 6, 10


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.reset()
    obs.disable()
    yield
    obs.reset()
    obs.disable()


def _segmentation():
    return mt.MetricCollection(
        [mt.JaccardIndex(num_classes=C, device="cpu"),
         mt.Accuracy(num_classes=C, average="macro", mdmc_average="global", device="cpu"),
         mt.ConfusionMatrix(num_classes=C, device="cpu")],
        device="cpu",
    )


def _batch(seed=0, n=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, C, H, W, generator=g), torch.randint(0, C, (n, H, W), generator=g)


def _profile(fn):
    """The user annotations a CPU profile of ``fn()`` records, as ``(name, start, end)`` sorted by start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    events = [e for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in events), key=lambda x: x[1])


def _inside(spans, outer):
    return [s for s in spans if outer[1] <= s[1] and s[2] <= outer[2] and s is not outer]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def test_a_collection_forward_nests_its_spans_by_time():
    obs.enable()
    mc = _segmentation()
    mc(*_batch())  # the first forward locks the input case; the profiled one is a step as a loop runs it
    spans = _profile(lambda: mc(*_batch(1)))
    (collection,) = _named(spans, "collection.forward")
    forwards = _named(_inside(spans, collection), "metric.forward")
    assert len(forwards) == 3 and len(_named(spans, "metric.forward")) == 3
    for forward in forwards:
        (body,) = _named(_inside(spans, forward), "metric.update_impl")
        checks = _named(_inside(spans, forward), "validation.check")
        # the Engine counts the logits without canonicalising them
        assert checks and not _named(_inside(spans, body), "validation.format")
        assert _named(_inside(spans, body), "validation.check")
        # the batch value's compute follows the update body inside the member's forward
        (value,) = _named(_inside(spans, forward), "metric.compute")
        assert value[1] >= body[2]
    assert len(_named(spans, "metric.update_impl")) == 3


def test_a_pass_end_compute_nests_the_members_computes():
    obs.enable()
    mc = _segmentation()
    mc(*_batch())
    spans = _profile(mc.compute)
    (collection,) = _named(spans, "collection.compute")
    assert len(_named(_inside(spans, collection), "metric.compute")) == 3


def test_disabled_the_profile_holds_no_port_span():
    mc = _segmentation()
    mc(*_batch())
    spans = _profile(lambda: (mc(*_batch(1)), mc.compute()))
    assert spans == [] and obs_core.spans_snapshot() == {}


def test_disabled_no_span_site_reaches_the_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"span {name} reached the profiler while obs was disabled")

    monkeypatch.setattr(obs_core, "_annotation", refuse)
    mc = _segmentation()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        mc(*_batch())
        mc.update(*_batch(1))
        mc.compute()
    assert obs.span("validation.check") is obs_core.NOOP_SPAN


def test_enabled_without_a_profiler_keeps_the_aggregates_and_opens_no_annotation(monkeypatch):
    def refuse(name):
        raise AssertionError(f"span {name} opened an annotation with no profiler recording")

    obs.enable()
    obs_core._annotation("warm")  # binds torch's check before record_function is refused
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    mc = _segmentation()
    mc(*_batch())
    spans = obs_core.spans_snapshot()
    counts = {}
    for (name, labels), agg in spans.items():
        counts[name] = counts.get(name, 0) + agg[0]
        assert agg[1] >= agg[2] >= 0
    assert counts["collection.forward"] == 1 and counts["metric.forward"] == 3
    assert counts["metric.update_impl"] == 3 and counts["metric.compute"] == 3
    assert counts["validation.check"] >= 3 and "validation.format" not in counts
    assert obs.counter_value("engine.logits_counts", form="confmat") == 2
    assert obs.counter_value("engine.logits_counts", form="stat_scores") == 1
    parents = {dict(labels).get("parent") for (name, labels) in spans if name == "metric.update_impl"}
    assert parents == {"metric.forward"}
    assert {dict(labels)["metric"] for (name, labels) in spans if name == "metric.update_impl"} == {
        "JaccardIndex", "Accuracy", "ConfusionMatrix"}


def test_forward_still_records_no_metric_update():
    obs.enable()
    mc = _segmentation()
    spans = _profile(lambda: mc(*_batch()))
    assert not _named(spans, "metric.update")
    assert not [k for k in obs_core.spans_snapshot() if k[0] == "metric.update"]


def test_a_public_update_nests_its_update_body():
    obs.enable()
    # samplewise counts go through the canonical one-hots; global ones straight from the logits
    for mdmc_average, formats in (("samplewise", 1), ("global", 0)):
        m = mt.Accuracy(num_classes=C, average="macro", mdmc_average=mdmc_average, device="cpu")
        spans = _profile(lambda: m.update(*_batch()))
        (update,) = _named(spans, "metric.update")
        (body,) = _named(_inside(spans, update), "metric.update_impl")
        assert _named(_inside(spans, body), "validation.check")
        assert len(_named(_inside(spans, body), "validation.format")) == formats


def _features(x):
    return x.reshape(x.shape[0], -1)[:, :8].float()


@pytest.mark.parametrize("make", [
    lambda: mt.FrechetInceptionDistance(feature=_features, feature_dim=8, device="cpu"),
    lambda: mt.KernelInceptionDistance(feature=_features, subset_size=2, device="cpu"),
    lambda: mt.InceptionScore(feature=_features, device="cpu"),
], ids=["fid", "kid", "inception_score"])
def test_an_image_update_spans_its_extractor_inside_the_update_body(make):
    obs.enable()
    metric = make()
    imgs = torch.randint(0, 256, (4, 3, 4, 4), dtype=torch.uint8)
    kwargs = {} if isinstance(metric, mt.InceptionScore) else {"real": True}
    spans = _profile(lambda: metric.update(imgs, **kwargs))
    (body,) = _named(spans, "metric.update_impl")
    (extractor,) = _named(_inside(spans, body), "extractor.forward")
    assert extractor[1] >= body[1]
    labels = [dict(labels) for (name, labels) in obs_core.spans_snapshot() if name == "extractor.forward"]
    assert labels == [{"metric": type(metric).__name__, "parent": "metric.update_impl"}]


def test_a_span_left_by_an_exception_closes_its_annotation():
    obs.enable()

    def fail():
        with pytest.raises(ValueError):
            with obs.span("unit.outer"):
                with obs.span("unit.inner"):
                    raise ValueError("boom")
        with obs.span("unit.after"):
            pass

    spans = _profile(fail)
    (outer,) = _named(spans, "unit.outer")
    assert _named(_inside(spans, outer), "unit.inner")
    (after,) = _named(spans, "unit.after")
    assert after[1] >= outer[2]
    assert obs_core._rt.tls.stack == []


def test_the_profiler_started_inside_a_span_annotates_only_later_spans():
    obs.enable()
    with obs.span("unit.before"):
        spans = _profile(lambda: obs.span("unit.inside").__enter__().__exit__(None, None, None))
    assert [s[0] for s in spans] == ["unit.inside"]


def test_the_card_smokes_device_count_leaves_out_the_annotations_device_copies(monkeypatch):
    # an enabled span under a CUDA profile records a device-side copy of its annotation; chip_smoke's
    # device-operation counts (obs off against on) must not take it for an operation
    from pathlib import Path
    from types import SimpleNamespace

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def event(name, device, annotation=False):
        return SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation)

    events = [event("metric.update", cpu, True), event("metric.update", cuda, True), event("cudaLaunchKernel", cpu),
              event("stat_scores_kernel", cuda), event("validation.format", cpu, True),
              event("validation.format", cuda), event("Memcpy DtoH (Device -> Pageable)", cuda)]
    prof = SimpleNamespace(events=lambda: events)
    assert [e.name for e in chip_smoke._device_events(prof)] == ["stat_scores_kernel",
                                                                  "Memcpy DtoH (Device -> Pageable)"]
