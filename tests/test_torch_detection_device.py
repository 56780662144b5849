"""The port's mAP device route (``metrics_tpu_torch/detection/device.py``) and the greedy matcher's
plain version (``metrics_tpu_torch/ops/coco_match.py``) against the JAX package's
``metrics_tpu/detection/device.py``, on the CPU.

Every discrete output is held bitwise: the exact int32 run intersections,
the matcher's codes (planted IoU-rank ties, ignored-gt groups, all-padding
blocks, more gts than a warp's lanes), the TP counts and the table columns.
The float32 values are bitwise too where the arithmetic is a single IEEE
operation in both packages (box terms on integer coordinates, precision
quotients and their envelope); box terms on float coordinates hold to two
float32 ulps, since XLA may contract a product and a sum into one
multiply-add.  Shapes are shared so the JAX references compile once each.
"""

import numpy as np
import pytest
import torch

from metrics_tpu.detection import device as jdev
from metrics_tpu.detection.mean_ap import MeanAveragePrecision as JaxMAP
from metrics_tpu_torch.detection import device as tdev
from metrics_tpu_torch.ops import coco_match as cm

A, T = 4, 10  # area ranges and IoU thresholds, as MeanAveragePrecision has them
F32_ULP = 2.0**-23


def _masks(rng, n, h, w):
    out = np.zeros((n, h, w), np.uint8)
    for j in range(n):
        y0, x0 = int(rng.integers(0, h - 4)), int(rng.integers(0, w - 4))
        out[j, y0 : y0 + int(rng.integers(1, 12)), x0 : x0 + int(rng.integers(1, 12))] = 1
    return out


def _run_table(masks):
    from metrics_tpu_torch._native import rle_encode

    runs = [rle_encode(m) for m in masks]
    table = np.zeros((len(runs), 64), np.int32)
    for i, r in enumerate(runs):
        table[i, : len(r)] = r
    return table


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 31, 32, 33, 100, 194, 1000, 4085, 8200, 10000, 327_000])
@pytest.mark.parametrize("lo", [8, 64])
def test_bucket_is_the_jax_ladder(n, lo):
    assert tdev.bucket(n, lo) == jdev.bucket(n, lo)


def test_segm_intersections_bitwise_with_padding_rows():
    rng = np.random.default_rng(0)
    dm, gm = _masks(rng, 6, 40, 56), _masks(rng, 5, 40, 56)
    d_pad, g_pad = np.zeros((8, 64), np.int32), np.zeros((8, 64), np.int32)
    d_pad[:6], g_pad[:5] = _run_table(dm), _run_table(gm)
    pd, pg = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")  # rows 6-7 / 5-7: all padding
    pd, pg = pd.ravel().astype(np.int32), pg.ravel().astype(np.int32)
    want = jdev.segm_intersections(d_pad, g_pad, pd, pg)
    got = tdev.segm_intersections(*(torch.from_numpy(a) for a in (d_pad, g_pad)), torch.from_numpy(pd).long(),
                                  torch.from_numpy(pg).long())
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    dense = np.array([[int((a & b).sum()) for b in list(gm) + [gm[0] * 0] * 3] for a in list(dm) + [dm[0] * 0] * 2])
    assert np.array_equal(got.numpy().reshape(8, 8), dense)


@pytest.mark.parametrize("integer", [True, False], ids=["integer_coords", "float_coords"])
def test_box_inter_union_against_jax(integer):
    rng = np.random.default_rng(1)
    lo = rng.uniform(0, 300, (64, 2, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0, 200, (64, 2, 2))], axis=2).astype(np.float32)
    if integer:
        boxes = np.round(boxes)
    want = jdev.box_inter_union(boxes[:, 0], boxes[:, 1])
    got = tdev.box_inter_union(torch.from_numpy(boxes[:, 0]), torch.from_numpy(boxes[:, 1]))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        if integer:
            assert np.array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=2 * F32_ULP, atol=0)


def _rank_case(seed, b, d, g, levels=4):
    """Ranks of IoUs on a coarse grid (ties everywhere), some slots padded, the ignore flags per area."""
    rng = np.random.default_rng(seed)
    ious = rng.integers(0, levels + 1, (b, d, g)) / levels
    ious[0, 0, :] = 0.5  # a tie across the whole row
    ious[0, 1, : min(g, 3)] = 0.75
    u = np.unique(ious)
    ranks = np.searchsorted(u, ious).astype(np.int32)
    nd, ng = rng.integers(0, d + 1, b), rng.integers(0, g + 1, b)
    nd[0], ng[0] = d, g
    for i in range(b):
        ranks[i, nd[i]:, :] = -1
        ranks[i, :, ng[i]:] = -1
    gig = np.zeros((A, b, g), bool)
    gig[1:] = rng.random((A - 1, b, g)) < 0.4
    thr = np.minimum(np.linspace(0.5, 0.95, T), 1 - 1e-10)
    return ranks, gig, np.searchsorted(u, thr, side="left").astype(np.int32)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("b,d,g", [(6, 8, 8), (5, 12, 40)], ids=["one_chunk", "gts_past_32"])
def test_matcher_plain_version_is_bitwise_the_jax_kernel(seed, b, d, g):
    ranks, gig, thr = _rank_case(seed, b, d, g)
    want = jdev.match_ranked_blocks(ranks, gig, thr)
    got = cm.coco_match_plain(torch.from_numpy(ranks), torch.from_numpy(gig), torch.from_numpy(thr))
    assert got.dtype == torch.uint8 and got.shape == (A, b, T, d)
    assert np.array_equal(got.numpy(), want)
    assert set(np.unique(want)) <= {0, 1, 2} and (want == 1).any()


def test_matcher_plain_version_with_thresholds_below_the_padding():
    # a threshold rank of -1 makes padded slots eligible: counted ones match, ignored ones keep key -1
    ranks, gig, _ = _rank_case(5, 5, 12, 40)
    thr = np.array([-1, 0, 2], np.int32)
    want = jdev.match_ranked_blocks(ranks, gig, thr)
    got = cm.coco_match_plain(torch.from_numpy(ranks), torch.from_numpy(gig), torch.from_numpy(thr))
    assert np.array_equal(got.numpy(), want)


def test_matcher_all_padding_block_and_empty_shapes():
    ranks = np.full((2, 3, 4), -1, np.int32)
    gig = np.zeros((A, 2, 4), bool)
    thr = np.zeros(3, np.int32)
    want = jdev.match_ranked_blocks(ranks, gig, thr)
    got = cm.coco_match_plain(torch.from_numpy(ranks), torch.from_numpy(gig), torch.from_numpy(thr))
    assert np.array_equal(got.numpy(), want) and not got.any()
    for shape in ((0, 3, 4), (2, 0, 4), (2, 3, 0)):
        codes = cm.coco_match(torch.full(shape, -1, dtype=torch.int32), torch.zeros((A, shape[0], shape[2]), dtype=torch.bool),
                              torch.zeros(3, dtype=torch.int32))
        assert codes.shape == (A, shape[0], 3, shape[1]) and not codes.any()


def test_match_ranked_blocks_takes_the_plain_version_on_the_cpu():
    ranks, gig, thr = _rank_case(7, 6, 8, 8)
    before = cm.coco_match.launches
    got = tdev.match_ranked_blocks(torch.from_numpy(ranks), torch.from_numpy(gig), torch.from_numpy(thr))
    assert cm.coco_match.launches == before
    assert np.array_equal(got.numpy(), jdev.match_ranked_blocks(ranks, gig, thr))


def test_coco_match_checks_its_operands():
    ranks, gig, thr = torch.zeros((2, 3, 4), dtype=torch.int32), torch.zeros((A, 2, 4), dtype=torch.bool), torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        cm.coco_match(ranks.long(), gig, thr)
    with pytest.raises(ValueError, match="gt_ignore"):
        cm.coco_match(ranks, gig[:, :1], thr)
    with pytest.raises(ValueError, match="thr_ranks"):
        cm.coco_match(ranks, gig, thr.long())
    with pytest.raises(TypeError):
        cm.coco_match(ranks.numpy(), gig, thr)


def test_score_tables_bitwise_against_jax():
    rng = np.random.default_rng(2)
    S, L, R = 5, 16, 101
    sizes = rng.integers(1, L + 1, S).astype(np.int32)
    sizes[-1] = 0  # a padded segment
    valid = np.arange(L)[None, :] < sizes[:, None]
    codes = (rng.integers(0, 3, (A, T, S, L)) * valid).astype(np.uint8)
    dout = (rng.random((A, S, L)) < 0.3) & valid
    npig = rng.integers(1, 9, (A, S)).astype(np.float64)
    kmin = np.stack([JaxMAP._recall_kmin(npig[a], np.linspace(0, 1, R)) for a in range(A)])
    want = jdev.score_tables(codes, valid, dout, kmin, sizes)
    got = tdev.score_tables(*(torch.from_numpy(x) for x in (codes, valid, dout, kmin, sizes)))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g.numpy(), w)
