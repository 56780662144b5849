"""The harness finds every cell's parts by name, and a cell, a configuration, a traffic mix and a
per-layer metric are added by adding files and entries alone."""

import json
import re
import shutil
import time

import pytest

from portbench.cell import ROOT, Cell
from portbench.harness import run
from portbench.tests._tiny import SEG_LIMITS, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = bench()


def test_the_file_has_the_contract_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"] == ["python3", "portbench/run.py"]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_configuration_mix_task_and_readers(workload):
    cell = Cell(workload)
    assert cell.config["name"] == cell.workload["config"]
    assert hasattr(cell.task(), "run") and hasattr(cell.task(), "control")
    assert cell.chips in (1, 4)
    e2e = {m["name"] for m in cell.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = cell.per_layer()
    assert per_layer and all(m["moves"] in e2e for m in per_layer)
    for m in per_layer:
        assert callable(cell.reader(m["name"]))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_each_configuration_file_lies_under_paths_and_names_its_cut(config):
    assert config["file"].startswith("portbench/configs/")
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"] and data["reduced"] == config["reduced"]
    assert "precision" in data and "assumed" in data


def test_a_cell_a_configuration_a_mix_and_a_metric_added_as_files_alone(tmp_path):
    """A throwaway cell: a new configuration file, a new traffic mix and a new per-layer metric in a copy of
    the benchmark, found and run by the unchanged harness (on the CPU, at a tiny size)."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    config = json.loads((ROOT / "portbench/configs/cityscapes_seg.json").read_text())
    config.update(name="tiny_seg", height=32, width=64, label_block=4, images_per_pass=6, limits=SEG_LIMITS)
    (tmp_path / "portbench/configs/tiny_seg.json").write_text(json.dumps(config))
    (tmp_path / "portbench/traffic/update_b3.json").write_text(json.dumps(
        {"call": "update", "batch": 3, "pool_batches": 2, "read_each_step": "JaccardIndex"}))
    (tmp_path / "portbench/metrics/tiny.steps.py").write_text(
        "def read(r):\n    return float(len(r.trace.spans('pb.step'))) if r.trace else None\n")
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny_seg", "source": "a test", "file": "portbench/configs/tiny_seg.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "tiny_seg.update_b3", "config": "tiny_seg", "traffic": "update_b3", "chips": 1,
                           "why": "a test"})
    b["end_to_end"][0]["workloads"].append("tiny_seg.update_b3")
    b["per_layer"].append({"name": "tiny.steps", "unit": "steps", "better": "higher", "source": "program_span",
                           "layer": "Collection", "moves": "mpixels_per_s", "workloads": ["tiny_seg.update_b3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = Cell("tiny_seg.update_b3", root=tmp_path)
    assert [m["name"] for m in cell.per_layer()] == ["tiny.steps"]
    plain = run(cell, 5, 0.3, False, "cpu", time.perf_counter())
    assert plain["correct"] and set(plain["metrics"]) == {"mpixels_per_s", "metric_peak_mib", "setup_s"}
    traced = run(cell, 5, 0.3, True, "cpu", time.perf_counter())
    assert traced["correct"] and traced["metrics"]["tiny.steps"]["value"] >= 1
    assert list(traced)[-1] == "checks"
