"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and ``nvcc``; without them they skip.  They
import neither JAX nor ``metrics_tpu``, so on a machine without JAX they run
without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import metrics_tpu_torch as mt
from metrics_tpu_torch.ops import stat_scores as ops
from metrics_tpu_torch.utils.data import _linspace_thresholds

SHAPES = [(1024, 1000), (848, 1000), (3, 5), (0, 4), (4096, 4097)]
NAN_BITS = {torch.bfloat16: (0x7FC0, -0x40), torch.float16: (0x7E00, -0x200)}  # (+NaN, -NaN) as int16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def logit_cases(n, c, dtype, label_dtype, seed, device):
    """Logits on a grid of eighths in [-2, 2] (ties in most rows), rows of NaN, -NaN,
    signed zeros and infinities, and labels out of range on both sides."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-16, 17, (n, c)) / 8).astype(np.float32)
    labels = rng.integers(0, c, n)
    if n >= 8 and c >= 4:
        x[0] = -np.inf
        x[1, 1::2] = np.nan
        x[2] = 0.0
        x[2, 0] = -0.0
        x[3, 1] = np.copysign(np.nan, -1.0)
        x[4, 2:4] = np.inf
        labels[5:8] = (c, -1, c + 100)
    logits = torch.from_numpy(x).to(device=device, dtype=dtype)
    if dtype in NAN_BITS and n >= 8 and c >= 4:  # the conversion may not keep a NaN's sign
        bits = logits.view(torch.int16)
        bits[1, 1::2], bits[3, 1] = NAN_BITS[dtype]
    return logits, torch.from_numpy(labels).to(device=device, dtype=label_dtype)


def assert_counts_equal(got, expected):
    for g, e in zip(got, expected):
        assert g.dtype == torch.int32
        assert torch.equal(g, e)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.bool])
@pytest.mark.parametrize("n,c", SHAPES)
def test_stat_scores_kernel_matches_plain(cuda, n, c, dtype):
    gen = torch.Generator(device=cuda).manual_seed(n + c)
    preds = torch.randint(0, 2, (n, c), device=cuda, generator=gen).to(dtype)
    target = torch.randint(0, 2, (n, c), device=cuda, generator=gen).to(dtype)
    before = ops.fused_stat_scores.launches
    got = ops.fused_stat_scores(preds, target)
    torch.cuda.synchronize()
    assert ops.fused_stat_scores.launches == before + 1
    assert_counts_equal(got, ops.fused_stat_scores_plain(preds, target))


@pytest.mark.cuda
def test_stat_scores_kernel_counts_values_outside_zero_one(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    preds = torch.randint(-1, 3, (300, 40), device=cuda, generator=gen, dtype=torch.int32)
    target = torch.randint(-1, 3, (300, 40), device=cuda, generator=gen, dtype=torch.int32)
    assert_counts_equal(ops.fused_stat_scores(preds, target), ops.fused_stat_scores_plain(preds, target))


@pytest.mark.cuda
@pytest.mark.parametrize("label_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("n,c", SHAPES + [(37, 9), (70, 1030), (16, 1)])
def test_stat_scores_logits_kernel_matches_plain(cuda, n, c, dtype, label_dtype):
    logits, labels = logit_cases(n, c, dtype, label_dtype, seed=n + c, device=cuda)
    before = ops.fused_stat_scores_logits.launches
    got = ops.fused_stat_scores_logits(logits, labels)
    torch.cuda.synchronize()
    assert ops.fused_stat_scores_logits.launches == before + 1
    assert_counts_equal(got, ops.fused_stat_scores_logits_plain(logits, labels))


@pytest.mark.cuda
def test_logits_kernel_takes_unaligned_rows(cuda):
    logits, labels = logit_cases(65, 32, torch.float32, torch.int64, seed=3, device=cuda)
    window = logits.reshape(-1)[1 : 1 + 64 * 32].reshape(64, 32)  # rows start 4 bytes past a 16-byte boundary
    assert_counts_equal(ops.fused_stat_scores_logits(window, labels[:64]),
                        ops.fused_stat_scores_logits_plain(window, labels[:64]))


@pytest.mark.cuda
def test_macro_metrics_on_cuda_go_through_the_kernel(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    preds = torch.rand((300, 12), device=cuda, generator=gen)
    target = torch.randint(0, 12, (300,), device=cuda, generator=gen)
    metric = mt.F1Score(num_classes=12, average="macro")
    reference = mt.F1Score(num_classes=12, average="macro", device="cpu")
    before = ops.fused_stat_scores_logits.launches, ops.fused_stat_scores.launches
    metric.update(preds, target)
    reference.update(preds.cpu(), target.cpu())
    assert (ops.fused_stat_scores_logits.launches, ops.fused_stat_scores.launches) == (before[0] + 1, before[1])
    for state in ("tp", "fp", "tn", "fn"):
        assert torch.equal(getattr(metric, state).cpu(), getattr(reference, state))
    torch.testing.assert_close(metric.compute().cpu(), reference.compute(), rtol=1e-6, atol=1e-7)
    with pytest.raises(RuntimeError, match="keeps its state on"):
        metric.update(preds.cpu(), target.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("kwargs,route", [
    (dict(), "logits"),
    (dict(average="macro"), "logits"),
    (dict(top_k=2), "canonical"),
    (dict(average="macro", ignore_index=3), "canonical"),
])
def test_accuracy_on_cuda_takes_its_route(cuda, kwargs, route):
    logits, labels = logit_cases(500, 12, torch.float32, torch.int64, seed=5, device=cuda)
    labels = labels.clamp(0, 11)
    metric = mt.Accuracy(num_classes=12, **kwargs)
    reference = mt.Accuracy(num_classes=12, device="cpu", **kwargs)
    before = ops.fused_stat_scores_logits.launches, ops.fused_stat_scores.launches
    metric.update(logits, labels)
    reference.update(logits.cpu(), labels.cpu())
    launched = (ops.fused_stat_scores_logits.launches - before[0], ops.fused_stat_scores.launches - before[1])
    assert launched == ((1, 0) if route == "logits" else (0, 1))
    for state in ("tp", "fp", "tn", "fn"):
        assert torch.equal(getattr(metric, state).cpu(), getattr(reference, state))
    torch.testing.assert_close(metric.compute().cpu(), reference.compute(), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------ curves
def tricky_scores(shape, seed):
    """Scores on a grid of eighths in [-1, 1] (most rows tie), with NaNs, signed zeros and infinities."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-8, 9, shape) / 8).astype(np.float32)
    flat = x.reshape(-1)
    for value, count in ((np.nan, 12), (-0.0, 12), (0.0, 12), (np.inf, 4), (-np.inf, 4)):
        flat[rng.choice(flat.size, count, replace=False)] = value
    return x


def assert_same_curves(card, cpu):
    """Bit for bit, but a NaN's payload (arithmetic on a NaN gives the canonical one on the GPU)."""
    if isinstance(cpu, (list, tuple)):
        assert len(card) == len(cpu)
        for a, b in zip(card, cpu):
            assert_same_curves(a, b)
        return
    assert card.device.type == "cuda" and card.dtype == cpu.dtype and card.shape == cpu.shape
    card = card.cpu()
    if not cpu.is_floating_point():
        assert torch.equal(card, cpu)
        return
    nan = torch.isnan(cpu)
    assert torch.equal(torch.isnan(card), nan)
    width = {2: torch.int16, 4: torch.int32, 8: torch.int64}[cpu.element_size()]
    assert torch.equal(card[~nan].view(width), cpu[~nan].view(width))


CURVE_CASES = {
    "binary": lambda rng: (tricky_scores(301, 1), rng.integers(0, 2, 301), {"pos_label": 1}),
    "multiclass": lambda rng: (tricky_scores((301, 6), 2), rng.integers(0, 6, 301), {"num_classes": 6}),
    "multilabel": lambda rng: (tricky_scores((301, 6), 3), rng.integers(0, 2, (301, 6)), {"num_classes": 6}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["roc", "precision_recall_curve"])
@pytest.mark.parametrize("case", CURVE_CASES)
def test_exact_curves_on_cuda_equal_the_plain_cpu_path(cuda, case, name):
    scores, target, kwargs = CURVE_CASES[case](np.random.default_rng(0))
    fn = getattr(mt.functional, name)
    cpu = fn(torch.from_numpy(scores), torch.from_numpy(target), **kwargs)
    assert_same_curves(fn(torch.from_numpy(scores).to(cuda), torch.from_numpy(target).to(cuda), **kwargs), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("max_fpr", [0.1, 0.5])
def test_partial_auroc_on_cuda_equals_the_plain_cpu_path(cuda, max_fpr):
    scores, target, kwargs = CURVE_CASES["binary"](np.random.default_rng(1))
    cpu = mt.functional.auroc(torch.from_numpy(scores), torch.from_numpy(target), max_fpr=max_fpr, **kwargs)
    card = mt.functional.auroc(torch.from_numpy(scores).to(cuda), torch.from_numpy(target).to(cuda), max_fpr=max_fpr, **kwargs)
    assert_same_curves(card, cpu)


@pytest.mark.cuda
def test_curve_collection_on_cuda_shares_its_buffers_and_matches_the_cpu(cuda):
    rng = np.random.default_rng(2)
    batches = [(torch.softmax(torch.from_numpy(rng.standard_normal((n, 9)).astype(np.float32)), 1),
                torch.from_numpy(rng.integers(0, 9, n))) for n in (200, 200, 77)]

    def collection(device):
        return mt.MetricCollection({"auroc": mt.AUROC(num_classes=9, device=device),
                                    "ap": mt.AveragePrecision(num_classes=9, device=device)}, device=device)

    card, cpu = collection(cuda), collection("cpu")
    for preds, target in batches:
        card.update(preds.to(cuda), target.to(cuda))
        cpu.update(preds, target)
    assert card["auroc"].preds__buf is card["ap"].preds__buf and card["auroc"].preds__len == 477
    assert torch.equal(card["auroc"].buffer_values("preds").cpu(), cpu["auroc"].buffer_values("preds"))
    got, want = card.compute(), cpu.compute()
    for key in want:
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-6, atol=0)


# ------------------------------------------------------ rest of classification
def rest_inputs(n=301, c=7, seed=4):
    """Tricky scores (and the same with their NaNs and -infs replaced), labels with some out of
    range, multilabel targets with an empty and a full row, weights, confidences on bin edges
    and past them, and probabilities with NaNs and a row of tied maxima."""
    rng = np.random.default_rng(seed)
    scores = tricky_scores((n, c), seed)
    finite = np.where(np.isnan(scores) | (scores == -np.inf), np.float32(0.25), scores)
    labels = rng.integers(0, c, n)
    labels[:3] = (c, -1, c + 4)
    multilabel = rng.integers(0, 2, (n, c))
    multilabel[0], multilabel[1] = 0, 1
    weights = (rng.random(n) + 0.5).astype(np.float32)
    edges = _linspace_thresholds(16)
    conf = np.concatenate([edges, np.nextafter(edges, 2), [np.nan, -0.0, 0.0, 1.5, -0.5, np.inf], rng.random(n)])
    with np.errstate(invalid="ignore"):
        probs = np.abs(scores) / np.nansum(np.abs(scores), 1, keepdims=True)
    probs[rng.choice(n, 5, replace=False), rng.integers(0, c, 5)] = np.nan
    probs[2] = probs[2, 0]
    return {"scores": scores, "finite": finite, "labels": labels, "multilabel": multilabel, "weights": weights,
            "conf": conf.astype(np.float32), "hits": np.arange(conf.size) % 2, "probs": probs.astype(np.float32),
            "in_range": labels.clip(0, c - 1)}


def _ranking_calls():
    from metrics_tpu_torch.functional.classification import ranking as rk
    from metrics_tpu_torch.functional.classification.hinge import _hinge_measures

    f = mt.functional
    bitwise = {
        "rank_positions": lambda s, t, w, y: rk._rank_inverse(s),
        "lrap_rank_counts": lambda s, t, w, y: rk._lrap_ranks(s, t == 1),
        "coverage_per_row": lambda s, t, w, y: rk._coverage_per_sample(s, t),
        "ranking_loss_per_row": lambda s, t, w, y: rk._lrl_per_sample(s, t),
        "coverage_error": lambda s, t, w, y: f.coverage_error(s, t),
        "hinge_per_sample": lambda s, t, w, y: _hinge_measures(s, y),
        "hinge_per_sample_ova_squared": lambda s, t, w, y: _hinge_measures(s, y, True, "one-vs-all"),
    }
    close = {
        "label_ranking_loss": lambda s, t, w, y: f.label_ranking_loss(s, t, sample_weight=w),
        "label_ranking_average_precision": lambda s, t, w, y: f.label_ranking_average_precision(s, t, sample_weight=w),
        "coverage_error_weighted": lambda s, t, w, y: f.coverage_error(s, t, sample_weight=w),
        "hinge_loss": lambda s, t, w, y: f.hinge_loss(s, y),
        "hinge_loss_ova_squared": lambda s, t, w, y: f.hinge_loss(s, y, squared=True, multiclass_mode="one-vs-all"),
    }
    return bitwise, close


def assert_close_on_card(card, cpu):
    """To rtol=1e-6, NaN as NaN: a float32 sum over rows runs in another order on the card."""
    assert card.device.type == "cuda" and card.dtype == cpu.dtype and card.shape == cpu.shape
    torch.testing.assert_close(card.cpu(), cpu, rtol=1e-6, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("scores", ["scores", "finite"])
@pytest.mark.parametrize("name", list(_ranking_calls()[0]) + list(_ranking_calls()[1]))
def test_ranking_and_hinge_on_cuda_equal_the_plain_cpu_path(cuda, name, scores):
    """Bitwise where no float sum runs in a device-dependent order (rank positions and counts, each
    row's coverage and loss, each sample's hinge loss, the unweighted coverage: a sum of integers)."""
    bitwise, close = _ranking_calls()
    x = rest_inputs()
    cpu = [torch.from_numpy(x[k]) for k in (scores, "multilabel", "weights", "labels")]
    call = bitwise.get(name) or close[name]
    want, got = call(*cpu), call(*(t.to(cuda) for t in cpu))
    if name in bitwise:
        assert_same_curves(got, want)
    else:
        assert_close_on_card(got, want)


@pytest.mark.cuda
def test_calibration_bins_and_top1_on_cuda_equal_the_plain_cpu_path(cuda):
    from metrics_tpu_torch.functional.classification.calibration_error import _bin_edges, _bin_indices, _ce_update

    x = rest_inputs()
    conf = torch.from_numpy(x["conf"])
    idx_cpu = _bin_indices(conf, _bin_edges(15, torch.device("cpu")))
    idx_card = _bin_indices(conf.to(cuda), _bin_edges(15, cuda))
    assert_same_curves(idx_card, idx_cpu)
    assert_same_curves(torch.bincount(idx_card, minlength=15), torch.bincount(idx_cpu, minlength=15))
    probs, labels = torch.from_numpy(x["probs"]), torch.from_numpy(x["in_range"])
    assert_same_curves(_ce_update(probs.to(cuda), labels.to(cuda)), _ce_update(probs, labels))


@pytest.mark.cuda
@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
@pytest.mark.parametrize("case", [("conf", "hits"), ("probs", "in_range")], ids=["edges", "probs"])
def test_calibration_error_on_cuda_equals_the_plain_cpu_path(cuda, case, norm):
    x = rest_inputs()
    preds, target = torch.from_numpy(x[case[0]]), torch.from_numpy(x[case[1]])
    want = mt.functional.calibration_error(preds, target, n_bins=15, norm=norm)
    assert_close_on_card(mt.functional.calibration_error(preds.to(cuda), target.to(cuda), n_bins=15, norm=norm), want)


@pytest.mark.cuda
def test_rest_of_classification_modules_on_cuda_match_the_cpu_and_skip_the_kernel(cuda):
    gen = torch.Generator().manual_seed(5)
    logits = torch.randn((600, 12), generator=gen)
    labels = torch.randint(0, 12, (600,), generator=gen)
    probs = torch.softmax(logits, 1)

    def family(device):
        return mt.MetricCollection({
            "cm": mt.ConfusionMatrix(num_classes=12, device=device), "jaccard": mt.JaccardIndex(num_classes=12, device=device),
            "mcc": mt.MatthewsCorrCoef(num_classes=12, device=device), "kappa": mt.CohenKappa(num_classes=12, device=device),
            "ce": mt.CalibrationError(device=device), "hinge": mt.HingeLoss(multiclass_mode="one-vs-all", device=device),
        }, device=device)

    card, cpu = family(cuda), family("cpu")
    before = ops.fused_stat_scores_logits.launches, ops.fused_stat_scores.launches
    for part in (slice(0, 256), slice(256, 512), slice(512, 600)):
        card.update(probs[part].to(cuda), labels[part].to(cuda))
        cpu.update(probs[part], labels[part])
    assert (ops.fused_stat_scores_logits.launches, ops.fused_stat_scores.launches) == before
    assert sorted(sorted(g) for g in card.compute_groups.values()) == sorted(sorted(g) for g in cpu.compute_groups.values())
    assert torch.equal(card["cm"].confmat.cpu(), cpu["cm"].confmat)
    got, want = card.compute(), cpu.compute()
    for key in want:
        assert_close_on_card(got[key], want[key])
