"""``MeanAveragePrecision`` of the port against the JAX package's, on the CPU.

Both routes of both packages see the same seeded inputs: the port's
``on_device=True`` (the device route on CPU tensors, the matcher's plain
version) against the JAX package's ``device=True``, and ``on_device=False``
(the C++ host route) against ``device=False``.  Every output is held
bitwise on integer-coordinate boxes and on masks (the codes, recall and the
float32 precision tables are exact by design); on float coordinates the
device routes hold to the JAX package's own ``VALUE_TOL = 1e-6``.  The
degenerate shapes are those of ``tests/detection/test_device_parity.py``:
an empty class, images without detections or gts, ``max_det=0``, maskless
images, mixed canvases and COCO RLE dicts.
"""

import pickle

import numpy as np
import pytest
import torch

import metrics_tpu_torch as mt
from metrics_tpu.detection import MeanAveragePrecision as JaxMAP
from metrics_tpu.detection import mean_ap as jmap
from metrics_tpu_torch._native import rle_encode
from metrics_tpu_torch.detection import mean_ap as tmap
from metrics_tpu_torch.ops import coco_match as cm
from tests.detection.test_device_parity import _bbox_batch, _blob_masks, _segm_batch

VALUE_TOL = 1e-6  # the JAX package's tolerance for float32 precision-table values


def _jax(preds, targets, route, **kwargs):
    m = JaxMAP(device=route, **kwargs)
    m.update(preds, targets)
    return {k: np.asarray(v) for k, v in m.compute().items()}


def _port(preds, targets, route, **kwargs):
    m = mt.MeanAveragePrecision(on_device=route, device="cpu", **kwargs)
    m.update(preds, targets)
    out = m.compute()
    assert all(v.device == torch.device("cpu") for v in out.values())
    assert m.last_compute_profile["device"] is route
    return {k: v.numpy() for k, v in out.items()}


def _same(got, want, tol=0.0):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        if tol:
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=tol, err_msg=key)
        else:
            assert np.array_equal(got[key], want[key]), (key, got[key], want[key])


def _both_routes(preds, targets, tol=0.0, **kwargs):
    for route in (True, False):
        _same(_port(preds, targets, route, **kwargs), _jax(preds, targets, route, **kwargs), tol if route else 0.0)


def _to_rle(batch, keep):
    return [{**{k: d[k] for k in keep}, "masks": [
        {"size": list(m.shape), "counts": tmap.rle_to_coco_string(rle_encode(m.astype(np.uint8)))} for m in d["masks"]
    ]} for d in batch]


@pytest.mark.parametrize("class_metrics", [False, True])
def test_bbox_integer_boxes_bitwise_on_both_routes(class_metrics):
    preds, targets = _bbox_batch(np.random.default_rng(11))
    _both_routes(preds, targets, class_metrics=class_metrics)
    assert float(_port(preds, targets, True)["map"]) > 0


@pytest.mark.parametrize("box_format", ["xywh", "cxcywh"])
def test_bbox_float_boxes_within_the_jax_tolerance(box_format):
    rng = np.random.default_rng(12)
    preds, targets = _bbox_batch(rng)
    for d in preds + targets:
        d["boxes"] = d["boxes"] + rng.uniform(-0.45, 0.45, d["boxes"].shape)
    _both_routes(preds, targets, tol=VALUE_TOL, box_format=box_format)


def test_segm_masks_bitwise_on_both_routes():
    preds, targets = _segm_batch(np.random.default_rng(10))
    _both_routes(preds, targets, iou_type="segm")


def test_segm_empty_classes_and_images_and_maskless_images():
    rng = np.random.default_rng(12)
    preds, targets = _segm_batch(rng, n_img=12, derive_preds=False)
    h, w = 48, 64
    empty = dict(masks=np.zeros((0, h, w), bool), scores=np.zeros(0), labels=np.zeros(0, np.int64))
    preds += [empty, dict(masks=_blob_masks(rng, 2, h, w), scores=rng.random(2), labels=np.array([9, 9])), empty]
    targets += [dict(masks=_blob_masks(rng, 2, h, w), labels=np.array([7, 7])),
                dict(masks=np.zeros((0, h, w), bool), labels=np.zeros(0, np.int64)),
                dict(masks=np.zeros((0, h, w), bool), labels=np.zeros(0, np.int64))]
    _both_routes(preds, targets, iou_type="segm", class_metrics=True)


def test_segm_max_det_zero():
    preds, targets = _segm_batch(np.random.default_rng(13), n_img=8)
    _both_routes(preds, targets, iou_type="segm", max_detection_thresholds=[0, 1, 10])


def test_segm_mixed_canvases():
    rng = np.random.default_rng(14)
    p1, t1 = _segm_batch(rng, n_img=6, canvas=(32, 40))
    p2, t2 = _segm_batch(rng, n_img=6, canvas=(56, 24))
    _both_routes(p1 + p2, t1 + t2, iou_type="segm")


def test_segm_coco_rle_dicts_equal_the_dense_masks():
    preds, targets = _segm_batch(np.random.default_rng(15), n_img=10)
    rle_preds, rle_targets = _to_rle(preds, ("scores", "labels")), _to_rle(targets, ("labels",))
    rle_targets[0]["masks"] = [{"size": m["size"], "counts": tmap.rle_from_coco_string(m["counts"]).tolist()}
                               for m in rle_targets[0]["masks"]]  # uncompressed counts beside the strings
    _both_routes(rle_preds, rle_targets, iou_type="segm")
    _same(_port(rle_preds, rle_targets, True, iou_type="segm"), _port(preds, targets, True, iou_type="segm"))


def test_rle_string_codec_and_box_helpers_match_the_jax_package():
    rng = np.random.default_rng(16)
    runs = [rle_encode(m) for m in _blob_masks(rng, 6, 30, 20).astype(np.uint8)]
    strings = [tmap.rle_to_coco_string(r) for r in runs]
    assert strings == [jmap.rle_to_coco_string(r) for r in runs]
    for got, want in zip(tmap.rle_from_coco_strings(strings), jmap.rle_from_coco_strings(strings)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(tmap.rle_from_coco_string(strings[0].decode()), runs[0])
    boxes = rng.uniform(0, 50, (7, 4))
    for fmt in ("xyxy", "xywh", "cxcywh"):
        assert np.array_equal(tmap.box_convert(boxes, fmt), jmap.box_convert(boxes, fmt))
    assert np.array_equal(tmap.box_iou(boxes[:4], boxes[3:]), jmap.box_iou(boxes[:4], boxes[3:]))
    masks = _blob_masks(rng, 4, 20, 24)
    assert np.array_equal(tmap.segm_iou(list(masks[:2]), list(masks[2:])), jmap.segm_iou(list(masks[:2]), list(masks[2:])))


def test_auto_route_follows_the_device_and_iou_type():
    assert mt.MeanAveragePrecision(iou_type="segm", device="cpu")._use_device() is False
    seg = mt.MeanAveragePrecision(iou_type="segm", device="cpu")
    seg.device = torch.device("cuda", 0)  # what the auto rule reads; nothing runs
    assert seg._use_device() is True
    assert mt.MeanAveragePrecision(device="cpu", on_device=True)._use_device() is True
    with pytest.raises(ValueError, match="on_device"):
        mt.MeanAveragePrecision(device="cpu", on_device="yes")


def test_profiles_and_states_live_on_the_host():
    preds, targets = _segm_batch(np.random.default_rng(17), n_img=5)
    m = mt.MeanAveragePrecision(iou_type="segm", device="cpu", on_device=True)
    m.update(preds, targets)
    assert set(m.last_update_profile) == {"validate_secs", "ingest_secs", "append_secs"}
    assert m.detection_mask_runs[0].dtype == torch.int32 and m.detections[0].dtype == torch.float64
    m.compute()
    assert {"prep", "blocks", "iou", "match", "tables", "summarize"} <= set(m.last_compute_profile)
    assert m.last_compute_profile["iou_cache_enabled"] is False


def test_forward_under_dist_sync_on_step_caches_the_blocks():
    preds, targets = _bbox_batch(np.random.default_rng(18), n_img=12)
    port = mt.MeanAveragePrecision(device="cpu", dist_sync_on_step=True)
    ref = JaxMAP(dist_sync_on_step=True)
    for lo in (0, 6):
        step_p = port(preds[lo : lo + 6], targets[lo : lo + 6])
        step_j = ref(preds[lo : lo + 6], targets[lo : lo + 6])
        _same({k: v.numpy() for k, v in step_p.items()}, {k: np.asarray(v) for k, v in step_j.items()})
    got = {k: v.numpy() for k, v in port.compute().items()}
    _same(got, {k: np.asarray(v) for k, v in ref.compute().items()})
    prof = port.last_compute_profile
    assert prof["iou_cache_enabled"] and prof["iou_blocks_cached"] == ref.last_compute_profile["iou_blocks_cached"] > 0
    assert prof["iou_blocks_new"] == 0
    port.reset()
    assert port.__dict__["_iou_cache"] is None


def test_load_jax_state_mid_stream_then_both_continue_equal():
    rng = np.random.default_rng(19)
    first, second = _segm_batch(rng, n_img=6), _segm_batch(rng, n_img=6)
    ref = JaxMAP(iou_type="segm", device=True)
    ref.update(*first)
    port = mt.MeanAveragePrecision(iou_type="segm", device="cpu")
    mt.load_jax_state(port, ref.state_pytree(), {"device": True})
    assert port.on_device is True and port.detection_mask_runs[0].dtype == torch.int32
    ref.update(*second)
    port.update(*second)
    _same({k: v.numpy() for k, v in port.compute().items()}, {k: np.asarray(v) for k, v in ref.compute().items()})


def test_pickle_mid_stream_then_continue():
    rng = np.random.default_rng(20)
    first, second = _bbox_batch(rng, n_img=6), _bbox_batch(rng, n_img=6)
    m = mt.MeanAveragePrecision(device="cpu", dist_sync_on_step=True)
    m(*first)
    clone = pickle.loads(pickle.dumps(m))
    assert "_iou_cache" not in clone.__dict__
    for metric in (m, clone):
        metric.update(*second)
    _same({k: v.numpy() for k, v in clone.compute().items()}, {k: v.numpy() for k, v in m.compute().items()})


def test_merge_state_keeps_the_lists_on_the_host():
    rng = np.random.default_rng(21)
    a, b = _bbox_batch(rng, n_img=5), _bbox_batch(rng, n_img=5)
    one = mt.MeanAveragePrecision(device="cpu")
    one.update(*a)
    other = mt.MeanAveragePrecision(device="cpu")
    other.update(*b)
    one.merge_state(other.state_pytree())
    both = mt.MeanAveragePrecision(device="cpu")
    both.update(a[0] + b[0], a[1] + b[1])
    _same({k: v.numpy() for k, v in one.compute().items()}, {k: v.numpy() for k, v in both.compute().items()})


def test_input_validation_matches_the_jax_messages():
    m = mt.MeanAveragePrecision(device="cpu")
    box = torch.tensor([[0.0, 0.0, 10.0, 10.0]])
    good_p = [dict(boxes=box, scores=torch.ones(1), labels=torch.zeros(1, dtype=torch.int64))]
    good_t = [dict(boxes=box, labels=torch.zeros(1, dtype=torch.int64))]
    for preds, target, match in (
        (good_p, good_t + good_t, "same length"),
        ([{k: v for k, v in good_p[0].items() if k != "scores"}], good_t, "scores"),
        ([dict(good_p[0], scores=torch.ones(2))], good_t, "must agree in length"),
        (good_p, [dict(good_t[0], labels=torch.zeros(3))], "must agree in length"),
    ):
        with pytest.raises(ValueError, match=match):
            m.update(preds, target)
    with pytest.raises(ValueError, match="box_format"):
        mt.MeanAveragePrecision(box_format="xy", device="cpu")
    m.update(good_p, good_t)  # tensors on the CPU are taken as they are
    assert float(m.compute()["map"]) == 1.0
    assert cm.coco_match.launches == 0


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_host_route_without_the_native_library_takes_the_python_fallbacks(iou_type, monkeypatch):
    import metrics_tpu_torch._native as native

    rng = np.random.default_rng(22)
    preds, targets = _bbox_batch(rng, n_img=8) if iou_type == "bbox" else _segm_batch(rng, n_img=8)
    want = _jax(preds, targets, False, iou_type=iou_type)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    _same(_port(preds, targets, False, iou_type=iou_type), want)
