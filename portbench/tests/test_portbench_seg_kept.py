"""What the segmentation window keeps for judging: host copies that share nothing with the metric, judged
exactly as the values themselves were when they stayed on the card, faults and all."""

import math
import time

import pytest
import torch

from portbench.faults import faults_of
from portbench.harness import run
from portbench.tasks import segmentation as seg
from portbench.tests._tiny import SEG_LIMITS, seg_cell

SEED = 2**31 + 91


def _storages(tensors):
    return {t.untyped_storage().data_ptr() for t in tensors}


def _metric_tensors(collection, *outputs):
    held = [getattr(m, k) for _, m in collection.items() for k in m._defaults]
    return held + [t for out in outputs for t in out.values()]


def test_kept_values_share_no_storage_with_the_metric_and_outlive_its_changes():
    cell = seg_cell()
    logits, labels = seg.make_pool(SEED, cell.config, cell.traffic, "cpu")
    collection = seg.build(cell.config, "cpu")
    out = collection(logits[0], labels[0])
    step_slots = seg.HostSlots(out, 2, False)
    kept_step = step_slots.get(step_slots.put(out))
    want_step = {k: t.clone() for k, t in kept_step.items()}
    res = collection.compute()
    pass_slots = seg.HostSlots(seg.pass_record(res, collection), 2, False)
    kept_res, kept_snap = seg.unpack_pass(pass_slots.get(pass_slots.put(seg.pass_record(res, collection))))
    want_res = {k: t.clone() for k, t in kept_res.items()}
    want_snap = {name: {k: t.clone() for k, t in st.items()} for name, st in kept_snap.items()}
    assert set(kept_snap) == {m["class"] for m in cell.config["metrics"]}

    kept = list(kept_step.values()) + list(kept_res.values()) + [t for st in kept_snap.values() for t in st.values()]
    assert not _storages(kept) & _storages(_metric_tensors(collection, out, res))

    # the metric's outputs and states changed in place, then updated and reset: the kept values stay
    for t in _metric_tensors(collection, out, res):
        t.add_(7)
    collection(logits[1], labels[1])
    collection.reset()
    for k, t in want_step.items():
        assert torch.equal(kept_step[k], t), k
    for k, t in want_res.items():
        assert torch.equal(kept_res[k], t), k
    for name, st in want_snap.items():
        for k, t in st.items():
            assert torch.equal(kept_snap[name][k], t), (name, k)


def test_slots_grow_by_chunks_and_keep_every_record():
    like = {"a": torch.zeros(3, dtype=torch.int32), ("b", "c"): torch.zeros(())}
    slots = seg.HostSlots(like, 2, False)
    records = [{"a": torch.full((3,), i, dtype=torch.int32), ("b", "c"): torch.tensor(i / 8)} for i in range(5)]
    assert [slots.put(r) for r in records] == list(range(5))
    assert len(slots.chunks) == 3  # a full chunk is followed by a new one at once
    for i, r in enumerate(records):
        got = slots.get(i)
        assert all(torch.equal(got[k], r[k]) and got[k].dtype == r[k].dtype for k in r)


def _judged_on_the_card(cell, seed, count):
    """``count`` steps as the harness ran them when it kept each step's batch values and each pass's
    ``compute()`` and state clones on the card until it judged them."""
    cfg, traffic = cell.config, cell.traffic
    logits, labels = seg.make_pool(seed, cfg, traffic, "cpu")
    collection = seg.build(cfg, "cpu")
    plan = seg.schedule(cfg, traffic)
    read_key = traffic["read_each_step"]

    def step(p, n):
        out = collection(logits[p][:n], labels[p][:n])
        float(out[read_key])
        return out

    for p, n in sorted({(0, n) for _, n in plan}):
        step(p, n)
    collection.compute()
    collection.reset()
    steps, passes = [], []
    j = 0
    for _ in range(count):
        p, n = plan[j]
        steps.append((len(passes), j, n, step(p, n)))
        j += 1
        if j == len(plan):
            res = collection.compute()
            float(res[read_key])
            passes.append((res, seg.states(collection)))
            collection.reset()
            j = 0
    return seg.judge(cfg, traffic, plan, logits, labels, steps, passes, seg.states(collection), SEG_LIMITS)


class _Clock:
    """A clock that moves one second a reading: a window of ``s`` seconds takes ``ceil(s)`` steps."""

    def __init__(self) -> None:
        self.now = 0.0

    def perf_counter(self) -> float:
        self.now += 1.0
        return self.now


FAULTS = [None, *faults_of(seg_cell())]


@pytest.mark.parametrize("fault", FAULTS, ids=[f or "sound" for f in FAULTS])
def test_a_window_of_fixed_steps_is_judged_as_when_its_values_stayed_on_the_card(monkeypatch, fault):
    cell = seg_cell()
    plan = len(seg.schedule(cell.config, cell.traffic))
    count = 2 * plan + 2  # two pass ends and an unfinished pass
    if fault is not None:
        faults_of(cell)[fault](monkeypatch)
    checks, attempted, failed = _judged_on_the_card(seg_cell(), SEED, count)
    monkeypatch.setattr(seg, "time", _Clock())
    result = run(cell, SEED, count - 0.5, False, "cpu", time.perf_counter())
    assert attempted == count + 2 + 1 == result["attempted"]
    assert result["failed"] == failed
    got = {k: c["value"] for k, c in result["checks"].items()}
    assert set(got) == set(dict(checks))
    assert all(got[k] == v or (math.isnan(got[k]) and math.isnan(v)) for k, v in checks), (got, checks)
    assert result["correct"] == (fault is None) == (failed == 0)
