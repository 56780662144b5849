"""The yardstick's FLOP and byte counts against independent counts."""

import importlib.util
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.cell import ROOT
from portbench.reference.inception import UNITS, PlainInception, conv_flops
from portbench.tasks.fid import unflatten, weight_layout


def _metric(name):
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), ROOT / "portbench" / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_inception_flops_match_the_flop_counter_on_the_plain_reference():
    layout = weight_layout()
    weights = {name: torch.zeros(shape, device="meta") for name, shape, _, _ in layout}
    net = PlainInception(weights)
    for side in (299, 160):
        x = torch.zeros(2, 3, side, side, device="meta")
        with FlopCounterMode(display=False) as counter:
            net.network(x)
        assert counter.get_total_flops() == 2 * conv_flops(side)
    assert conv_flops(299) == _metric("fid.step_mfu_pct").flops_per_image()
    assert len(UNITS) == 94


def test_weights_unflatten_to_every_unit():
    sizes = sum(int(torch.Size(s).numel()) for _, s, _, _ in weight_layout())
    w = unflatten(torch.arange(sizes, dtype=torch.float32))
    assert len(w) == 5 * 94 + 1 and w["fc.weight"].shape == (1008, 2048)


def test_seg_step_bytes_by_hand():
    m = _metric("seg.step_roofline_pct")
    members = json.loads((ROOT / "portbench/configs/cityscapes_seg.json").read_text())["metrics"]
    # one image of 1024 x 2048: float32 logits of 19 classes, int64 labels, the states read and written once:
    # two 19 x 19 int32 matrices, and the accuracy's per-class stat scores and two scalars
    pixels = 1024 * 2048
    by_hand = pixels * 19 * 4 + pixels * 8 + 2 * (19 * 19 * 4 + (4 * 19 + 2) * 4 + 19 * 19 * 4)
    assert m.step_bytes(1, 19, 1024, 2048, members) == by_hand == 176_167_168
    micro = [{"class": "Accuracy", "kwargs": {"num_classes": 19}}]
    assert m.state_bytes(19, micro) == (4 + 2) * 4
