"""Each traffic generator makes the same inputs from the same seed, and other inputs from another."""

import torch

from portbench.cell import Cell
from portbench.tasks import fid, segmentation
from portbench.tests._tiny import fid_cell, seg_cell

BIG_SEED = 2**31 + 12345


def test_segmentation_pool_is_a_function_of_the_seed():
    cell = seg_cell()
    a = segmentation.make_pool(BIG_SEED, cell.config, cell.traffic, "cpu")
    b = segmentation.make_pool(BIG_SEED, cell.config, cell.traffic, "cpu")
    c = segmentation.make_pool(BIG_SEED + 1, cell.config, cell.traffic, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a[0] + a[1], b[0] + b[1]))
    assert not torch.equal(a[0][0], c[0][0])
    logits, labels = a[0][0], a[1][0]
    assert logits.dtype == torch.float32 and labels.dtype == torch.int64
    assert logits.shape == (4, 19, 32, 64) and labels.shape == (4, 32, 64)
    top2 = logits.topk(2, dim=1).values
    assert bool((top2[:, 0] > top2[:, 1]).all())  # one strict maximum a pixel


def test_segmentation_schedule_covers_the_split_once_a_pass():
    cell = seg_cell()
    plan = segmentation.schedule(cell.config, cell.traffic)
    assert sum(n for _, n in plan) == cell.config["images_per_pass"] and plan[-1] == (0, 2)
    full = segmentation.schedule({"images_per_pass": 500}, Cell("cityscapes_seg.logits_b1").traffic)
    assert len(full) == 500 and full[-1] == (499 % 64, 1) and {n for _, n in full} == {1}


def test_fid_inputs_and_weights_are_functions_of_the_seed():
    for traffic in ("images_b50", "features_b50000"):
        cell = fid_cell(traffic)
        a = fid.prepare(BIG_SEED, cell.config, cell.traffic, "cpu")
        b = fid.prepare(BIG_SEED, cell.config, cell.traffic, "cpu")
        c = fid.prepare(BIG_SEED + 1, cell.config, cell.traffic, "cpu")
        assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2]) and a[3] == b[3] and a[4] == b[4]
        assert not torch.equal(a[1], c[1])
        if traffic == "images_b50":
            assert (a[0] == b[0]).all() and a[1].dtype == torch.uint8 and a[1].shape == (4, 3, 32, 32)
        else:
            assert a[0] is None and bool((a[1] >= 0).all()) and a[1].shape == (200, 64)
