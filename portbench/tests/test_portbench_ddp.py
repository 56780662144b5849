"""The data-parallel segmentation cell on the CPU: four gloo ranks at a tiny size, through the harness.

The cell comes out correct; each sync fault of its kind (one rank's batch left out of the step's synced
value, one rank's pass state counted twice), a rank whose answers differ from rank 0's in a bit, and the
control (bfloat16 logits) come out not correct; each of its per-layer readers gives a number from a traced
run, or ``None`` where the trace lacks its spans or its device operations; and
a rank that dies ends the run non-zero, with no result, soon."""

import subprocess
import sys
import time

import pytest

from portbench.cell import ROOT, Cell, peaks
from portbench.faults import faults_of
from portbench.harness import Reading, run, within
from portbench.tracing import Tracer

NAME = "cityscapes_seg_ddp4.sync_step_b1"
SEED = 2**31 + 77
READERS = ["ddp.sync_ms_per_step", "ddp.wire_ms_per_step", "ddp.preflight_ms_per_step", "ddp.collectives_per_step",
           "ddp.sync_kib_per_step", "ddp.compute_ms", "seg.host_ms_per_step", "seg.host_syncs_per_step",
           "seg.device_ms_per_step", "seg.step_roofline_pct", "device_idle_pct.seg"]
ON_CARD = {"seg.device_ms_per_step", "seg.step_roofline_pct", "device_idle_pct.seg"}  # no device operation here
SPANS = {"ddp.sync_ms_per_step", "ddp.wire_ms_per_step", "ddp.preflight_ms_per_step", "ddp.collectives_per_step"}


def ddp_cell() -> Cell:
    cell = Cell(NAME)
    cell.config.update(height=32, width=64, label_block=4, images_per_pass=16)
    cell.traffic.update(pool_batches=3)
    return cell


def test_the_cell_lists_its_readers_and_takes_four_cards():
    cell = Cell(NAME)
    assert cell.chips == 4 and cell.config["world_size"] == 4 and cell.config["backend"] == "nccl"
    assert all(m["kwargs"]["dist_sync_on_step"] for m in cell.config["metrics"])
    assert sorted(m["name"] for m in cell.per_layer()) == sorted(READERS)
    assert {m["name"] for m in cell.end_to_end()} == {"mpixels_per_s", "metric_peak_mib", "setup_s"}


def test_the_tiny_cell_is_correct():
    result = run(ddp_cell(), SEED, 0.5, False, "cpu", time.perf_counter())
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert set(result["checks"]) == {"count_diff", "miou_err", "acc_err", "rank_diff"}
    assert result["checks"]["rank_diff"]["value"] == 0 and result["device"]["count"] == 4


@pytest.mark.parametrize("fault", ["rank_left_out", "rank_twice"])
def test_a_sync_fault_is_not_correct(monkeypatch, fault):
    cell = ddp_cell()
    cell.task()  # the task registers its kind's faults
    faults_of(cell)[fault](monkeypatch)
    result = run(cell, SEED, 0.3, False, "cpu", time.perf_counter())
    assert not result["correct"] and result["failed"] > 0, result["checks"]


def test_a_rank_whose_answers_differ_is_not_correct(monkeypatch):
    import portbench.tasks.segmentation_ddp as task

    monkeypatch.setattr(task, "FAULT", "rank_off")
    result = run(ddp_cell(), SEED, 0.3, False, "cpu", time.perf_counter())
    assert not result["correct"] and result["checks"]["rank_diff"]["value"] > 0, result["checks"]
    assert result["checks"]["count_diff"]["value"] == 0 and result["checks"]["miou_err"]["value"] < 1e-4


def test_the_control_is_not_correct():
    cell = ddp_cell()
    limits = cell.limits()
    checks, attempted, failed = cell.task().control(cell, SEED, "cpu", limits)
    assert failed > 0 and attempted > failed
    assert not all(within(v, limits.get(k)) for k, v in checks), checks


def test_each_reader_reads_a_traced_run_or_gives_none():
    cell = ddp_cell()
    tracer = Tracer(True)
    out = cell.task().run(cell, seed=SEED, seconds=0.5, tracer=tracer, device="cpu", t0=time.perf_counter(),
                          limits=cell.limits())
    reading = Reading(tracer.trace, out, cell, peaks())
    got = {name: cell.reader(name)(reading) for name in READERS}
    assert all(got[name] is None for name in ON_CARD), got
    assert got["seg.host_syncs_per_step"] == 0  # no card: no copy to the host
    assert all(got[name] is not None and got[name] > 0 for name in READERS
               if name not in ON_CARD | {"seg.host_syncs_per_step"}), got
    assert out.counts["ranks"] == 4 and out.counts["images"] == out.counts["steps"]  # rank 0's own, one a step
    assert got["ddp.collectives_per_step"] == 12  # three members, each a meta row, digests, sizes and the blob
    # without the port's spans (as at a port that lacks them), the span readers give None
    tracer.trace.ranges = {k: v for k, v in tracer.trace.ranges.items() if k.startswith("pb.")}
    assert all(cell.reader(name)(reading) is None for name in SPANS)
    assert cell.reader("ddp.compute_ms")(reading) > 0


SCRIPT = r"""
import sys, time
sys.path.insert(0, sys.argv[1])
from portbench.harness import emit, run
from portbench.tests.test_portbench_ddp import ddp_cell
import portbench.tasks.segmentation_ddp as task
task.FAULT = "rank_dies"
emit(run(ddp_cell(), 5, 5.0, False, "cpu", time.perf_counter()))
"""


def test_a_rank_that_dies_ends_the_run_non_zero_and_soon():
    start = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT)], capture_output=True, text=True, timeout=240,
                          cwd=ROOT)
    assert proc.returncode != 0 and "{" not in proc.stdout, proc.stdout
    assert "rank 3 exited with 3" in proc.stderr, proc.stderr[-2000:]
    assert time.monotonic() - start < 120
