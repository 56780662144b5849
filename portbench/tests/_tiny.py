"""Cells of the benchmark cut to sizes the CPU runs in seconds, for the tests."""

import json

from portbench.cell import ROOT, Cell

SEG_LIMITS = Cell("cityscapes_seg.logits_b1").limits()


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def seg_cell() -> Cell:
    cell = Cell("cityscapes_seg.logits_b1")
    cell.config.update(height=32, width=64, label_block=4, images_per_pass=10)
    cell.traffic.update(batch=4, pool_batches=2)
    return cell


def fid_cell(traffic: str) -> Cell:
    b = bench()
    name = f"cifar10_fid.tiny_{traffic}"
    b["workloads"].append({"name": name, "config": "cifar10_fid", "traffic": traffic, "chips": 1, "why": "a test"})
    cell = Cell(name, bench=b)
    if traffic == "images_b50":
        cell.traffic.update(batch=2, real_per_pass=4, fake_per_pass=4)
    else:
        cell.config["feature"] = 64
        cell.traffic.update(batch=50, real_per_pass=200, fake_per_pass=200)
    return cell
