"""On the card: the control (the plain reference one step below the configuration's precision, in the
program's place) fails at least one of each cell's limits, and the program passes them, at a size a test
run holds.  The full-size readings are taken with ``portbench/control.py``.

    python -m pytest -p no:cacheprovider -m cuda portbench/tests
"""

import time

import pytest
import torch

from portbench.cell import Cell
from portbench.harness import within
from portbench.tracing import Tracer

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the controls and the program run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


def _small(name: str) -> Cell:
    cell = Cell(name)
    if cell.config["task"] == "segmentation":
        cell.config.update(height=256, width=512, images_per_pass=18)
        cell.traffic.update(batch=4, pool_batches=2)
    elif cell.traffic["input"] == "images":
        cell.traffic.update(real_per_pass=1000, fake_per_pass=1000)
    # the features mix runs whole: its pass is under a second, and fewer rows leave the covariances worse
    # conditioned than the limit on the FID value was set for
    return cell


CELLS = ["cityscapes_seg.logits_b1", "cifar10_fid.images_b50", "cifar10_fid.features_b50000"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_fails_and_the_program_passes(cuda, name, seed):
    cell = _small(name)
    limits = cell.limits()
    checks, _, _ = cell.task().control(cell, seed, cuda, limits)
    assert not all(within(v, limits.get(k)) for k, v in checks), checks
    out = cell.task().run(cell, seed=seed, seconds=1.0, tracer=Tracer(False), device=cuda, t0=time.perf_counter(),
                          limits=limits)
    assert out.failed == 0 and all(within(v, limits.get(k)) for k, v in out.checks), out.checks
