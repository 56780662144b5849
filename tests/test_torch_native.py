"""The port's copy of the C++ host library (``metrics_tpu_torch/_native``) against the JAX package's.

Every public function runs on the same seeded inputs in both packages, once
through the built library and once through the port's pure-Python fallback
(``get_lib`` patched to report no library), and must return equal arrays:
the fallbacks are the host semantics, not an approximation.  The port's
library builds under ``build/native/`` at the root of the checkout, never
beside its source.
"""

import numpy as np
import pytest

import metrics_tpu._native as jn
import metrics_tpu_torch._native as tn

ROOT = tn.SOURCE.parents[2]


@pytest.fixture(params=["library", "fallback"])
def native(request, monkeypatch):
    if request.param == "library":
        assert tn.native_available()
    else:
        monkeypatch.setattr(tn, "get_lib", lambda: None)
    return tn


def _equal(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.array_equal(got, want), (got, want)


def _masks(rng, n=5, h=17, w=13):
    return (rng.random((n, h, w)) < 0.3).astype(np.uint8)


def test_the_source_is_the_jax_package_copy_and_builds_under_build():
    assert tn.SOURCE.read_bytes() == (ROOT / "metrics_tpu" / "_native" / "native.cpp").read_bytes()
    path = tn.build()
    assert path.is_file() and path.parent == ROOT / "build" / "native"


def test_edit_distances(native):
    rng = np.random.default_rng(0)
    words = [[str(w) for w in rng.integers(0, 6, rng.integers(0, 9))] for _ in range(12)]
    preds, targets = words[:6], words[6:]
    assert native.edit_distance(preds[0], targets[0]) == jn.edit_distance(preds[0], targets[0])
    _equal(native.edit_distance_batch(preds, targets), jn.edit_distance_batch(preds, targets))
    _equal(native.edit_distance_batch([], []), np.zeros(0, np.int64))


def test_rle_codec(native):
    rng = np.random.default_rng(1)
    masks = _masks(rng)
    masks[0] = 1  # a mask that starts with foreground: a zero first run
    runs = [native.rle_encode(m) for m in masks]
    _equal(tuple(runs), tuple(jn.rle_encode(m) for m in masks))
    _equal(native.rle_encode_batch(masks), jn.rle_encode_batch(masks))
    for m, r in zip(masks, runs):
        _equal(native.rle_decode(r, m.shape), jn.rle_decode(r, m.shape))
        assert np.array_equal(native.rle_decode(r, m.shape), m)
        assert native.rle_area(r) == jn.rle_area(r) == int(m.sum())
    flat, counts = jn.rle_encode_batch(masks)
    want = jn.rle_area_batch(flat, counts)
    got = native.rle_area_batch(flat, counts)
    assert got is None if native.get_lib() is None else np.array_equal(got, want)
    for crowd in (False, True):
        assert native.rle_iou(runs[1], runs[2], crowd) == jn.rle_iou(runs[1], runs[2], crowd)


def test_coco_matching_and_tables(native):
    rng = np.random.default_rng(2)
    ious = rng.integers(0, 5, (6, 4)) / 4.0
    gig = np.array([False, False, True, True])
    thr = np.array([0.5, 0.75])
    want = jn.coco_match(ious, gig, thr)
    got = native.coco_match(ious, gig, thr)
    nd, ng = np.array([2, 3, 1]), np.array([2, 1, 3])
    flat = rng.integers(0, 5, int((nd * ng).sum())) / 4.0
    gig_flat = rng.random(int(ng.sum())) < 0.3
    codes = jn.coco_match_blocks(flat, nd, ng, gig_flat, thr)
    dboxes, gboxes = rng.uniform(0, 20, (6, 4)), rng.uniform(0, 20, (6, 4))
    dboxes[:, 2:] += dboxes[:, :2]
    gboxes[:, 2:] += gboxes[:, :2]
    masks = _masks(rng, n=5)
    enc = [jn.rle_encode(m) for m in masks]
    cols = np.array([3, 0, 4, 1, 5, 2])
    tables = (codes, cols, rng.random(6) < 0.2, np.array([0, 3]), np.array([3, 3]), np.array([2.0, 0.0]), np.linspace(0, 1, 11))
    calls = [
        (got, want),
        (native.coco_match_blocks(flat, nd, ng, gig_flat, thr), codes),
        (native.box_iou_blocks(dboxes, nd, gboxes[:6], ng), jn.box_iou_blocks(dboxes, nd, gboxes[:6], ng)),
        (native.rle_iou_blocks(np.concatenate(enc[:2]), [len(e) for e in enc[:2]], np.concatenate(enc[2:]),
                               [len(e) for e in enc[2:]], [2], [3]),
         jn.rle_iou_blocks(np.concatenate(enc[:2]), [len(e) for e in enc[:2]], np.concatenate(enc[2:]),
                           [len(e) for e in enc[2:]], [2], [3])),
        (native.coco_tables(*tables), jn.coco_tables(*tables)),
    ]
    for have, expected in calls:
        if native.get_lib() is None:
            assert have is None  # the caller runs its own fallback
        else:
            _equal(have, expected)


def test_linear_assignment(native):
    rng = np.random.default_rng(3)
    cost = rng.random((4, 5, 5))
    _equal(native.lap_batch(cost), jn.lap_batch(cost))
    _equal(native.lap_batch(np.zeros((2, 0, 0))), np.zeros((2, 0), np.int64))
    with pytest.raises(ValueError, match="non-finite"):
        native.lap_batch(np.full((1, 2, 2), np.nan))
    with pytest.raises(ValueError, match="batch, n, n"):
        native.lap_batch(np.zeros((2, 3)))
