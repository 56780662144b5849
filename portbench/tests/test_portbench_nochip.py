"""A run without a card exits non-zero and prints no result; so does a run from a directory that holds
only ``BENCHMARK.json`` and the benchmark's own files."""

import os
import shutil
import subprocess
import sys

import pytest

from portbench.cell import ROOT


def _run(cwd, workload):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", workload, "--seed", "3",
                           "--seconds", "1", "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("workload", ["cityscapes_seg.logits_b1", "cifar10_fid.images_b50"])
def test_no_card_no_result(workload):
    proc = _run(ROOT, workload)
    assert proc.returncode != 0
    assert "{" not in proc.stdout and "needs 1 CUDA device" in proc.stderr


def test_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    proc = _run(tmp_path, "cityscapes_seg.logits_b1")
    assert proc.returncode != 0 and "{" not in proc.stdout
