"""A run with the timed path broken underneath comes out not correct.

These drive the whole of a run but the look for a card (on the CPU, at a tiny size), once for each fault
the cell can have (``portbench/faults.py``): a step that leaves the state unchanged, half of each batch left
out, and an answer altered where it is produced.  Every cell takes one card, so there is no exchange between
cards to leave out.  ``portbench/control.py --fault`` reads the same faults at each cell's own size."""

import time

import pytest

from portbench.faults import faults_of
from portbench.harness import run
from portbench.tests._tiny import fid_cell, seg_cell

CELLS = {"seg": seg_cell, "images": lambda: fid_cell("images_b50"), "features": lambda: fid_cell("features_b50000")}
CASES = [(kind, fault) for kind, make in CELLS.items() for fault in faults_of(make())]


def _run(cell):
    return run(cell, 2**31 + 77, 0.3, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("kind", list(CELLS))
def test_the_unbroken_tiny_runs_are_correct(kind):
    assert _run(CELLS[kind]())["correct"]


@pytest.mark.parametrize("kind,fault", CASES, ids=[f"{k}-{f}" for k, f in CASES])
def test_a_fault_is_not_correct(monkeypatch, kind, fault):
    cell = CELLS[kind]()
    faults_of(cell)[fault](monkeypatch)
    result = _run(cell)
    assert not result["correct"] and result["failed"] > 0, result["checks"]
