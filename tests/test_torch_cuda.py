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


# ---------------------------------------------------------- regression, pairwise
def regression_inputs(n=3000, d=5, seed=11):
    """Positive float32 targets and predictions (every regression functional's domain), 1-D and (n, d),
    and 1-D scores with ties, signed zeros, infinities and NaN for the ranks."""
    rng = np.random.default_rng(seed)
    target = np.exp(rng.standard_normal((n, d)) * 0.5).astype(np.float32)
    preds = (target * np.exp(rng.standard_normal((n, d)) * 0.1)).astype(np.float32)
    tricky = np.round(rng.standard_normal(n) * 2, 1).astype(np.float32)
    tricky[rng.integers(0, n, 40)] = np.array([np.nan, -np.nan, -0.0, 0.0, np.inf, -np.inf, 1.0, 1.0] * 5, np.float32)
    return {"preds": preds, "target": target, "tricky": tricky}


def _regression_calls():
    f = mt.functional
    one = lambda fn, **kw: (lambda p, t: fn(p[:, 0], t[:, 0], **kw))  # noqa: E731
    return {
        "mean_squared_error": one(f.mean_squared_error),
        "rmse": one(f.mean_squared_error, squared=False),
        "mean_absolute_error": one(f.mean_absolute_error),
        "mean_squared_log_error": one(f.mean_squared_log_error),
        "mean_absolute_percentage_error": one(f.mean_absolute_percentage_error),
        "symmetric_mean_absolute_percentage_error": one(f.symmetric_mean_absolute_percentage_error),
        "weighted_mean_absolute_percentage_error": one(f.weighted_mean_absolute_percentage_error),
        "tweedie_1": one(f.tweedie_deviance_score, power=1),
        "tweedie_1.5": one(f.tweedie_deviance_score, power=1.5),
        "tweedie_2": one(f.tweedie_deviance_score, power=2),
        "tweedie_3": one(f.tweedie_deviance_score, power=3),
        "explained_variance_raw": lambda p, t: f.explained_variance(p, t, multioutput="raw_values"),
        "explained_variance_weighted": lambda p, t: f.explained_variance(p, t, multioutput="variance_weighted"),
        "r2_raw": lambda p, t: f.r2_score(p, t, multioutput="raw_values"),
        "r2_adjusted": one(f.r2_score, adjusted=4),
        "pearson": one(f.pearson_corrcoef),
        "spearman": one(f.spearman_corrcoef),
        "cosine_similarity_none": lambda p, t: f.cosine_similarity(p, t, reduction="none"),
        "cosine_similarity_mean": lambda p, t: f.cosine_similarity(p, t, reduction="mean"),
    }


def _close_in_units(card, cpu, rtol=2.0**-24 * 3000 * 5, atol=0.0):
    """A float32 sum of at most 3000 x 5 terms added in another order on the card: n U relative;
    scores that cancel (R², explained variance, correlations) get the same bound as an absolute one."""
    assert card.device.type == "cuda" and card.dtype == cpu.dtype and card.shape == cpu.shape
    torch.testing.assert_close(card.cpu(), cpu, rtol=rtol, atol=atol, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_regression_calls()))
def test_regression_functionals_on_cuda_equal_the_plain_cpu_path(cuda, name):
    x = regression_inputs()
    p, t = torch.from_numpy(x["preds"]), torch.from_numpy(x["target"])
    call = _regression_calls()[name]
    want, got = call(p, t), call(p.to(cuda), t.to(cuda))
    cancels = name.startswith(("explained", "r2", "pearson", "spearman", "cosine"))
    _close_in_units(got, want, atol=8 * 2.0**-24 * 3000 * 5 if cancels else 0.0)


@pytest.mark.cuda
def test_ranks_and_tweedie_checks_on_cuda_equal_the_cpu_path(cuda):
    from metrics_tpu_torch.functional.regression.spearman import _rank_data

    tricky = torch.from_numpy(regression_inputs()["tricky"])
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        assert_same_curves(_rank_data(tricky.to(cuda, dtype)), _rank_data(tricky.to(dtype)))
    ones = torch.ones(8, device=cuda)
    for power, preds, target in ((1, -ones, ones), (1.5, ones, -ones), (2, ones, 0 * ones), (-1, 0 * ones, ones)):
        with pytest.raises(ValueError):
            mt.functional.tweedie_deviance_score(preds, target, power=power)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pairwise_linear_similarity", "pairwise_cosine_similarity",
                                  "pairwise_euclidean_distance", "pairwise_manhattan_distance"])
def test_pairwise_on_cuda_equal_the_plain_cpu_path(cuda, name):
    """With TF32 off (torch's default, which the port leaves to the caller) a d-term dot product differs
    by at most d U of the sum of |terms|; a euclidean distance by the square root of that, its squares
    cancelling; a manhattan distance (one sign) by d U relative."""
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(12)
    x, y = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in ((700, 64), (90, 64)))
    fn = getattr(mt.functional, name)
    for second in (y, None):
        want = fn(x, second)
        got = fn(x.to(cuda), None if second is None else second.to(cuda))
        other = x if second is None else second
        scale = (x.abs() @ other.abs().T).double()
        if name == "pairwise_euclidean_distance":
            sq = (x * x).sum(1, keepdim=True).double() + (other * other).sum(1).double() + 2 * scale
            bound = torch.sqrt(68 * 2.0**-24 * sq)
        elif name == "pairwise_cosine_similarity":
            bound = torch.full_like(scale, 72 * 2.0**-24)
        elif name == "pairwise_linear_similarity":
            bound = 64 * 2.0**-24 * scale
        else:
            bound = 64 * 2.0**-24 * want.double()
        assert got.device.type == "cuda" and got.shape == want.shape and got.dtype == want.dtype
        assert bool(((got.cpu().double() - want.double()).abs() <= bound + 1e-30).all())


@pytest.mark.cuda
def test_regression_modules_on_cuda_match_the_cpu_and_skip_the_kernel(cuda):
    x = regression_inputs()
    p, t = torch.from_numpy(x["preds"]), torch.from_numpy(x["target"])

    def collection(device):
        return mt.MetricCollection({
            "mse": mt.MeanSquaredError(device=device), "mae": mt.MeanAbsoluteError(device=device),
            "msle": mt.MeanSquaredLogError(device=device), "tweedie": mt.TweedieDevianceScore(power=2, device=device),
            "r2": mt.R2Score(device=device), "ev": mt.ExplainedVariance(device=device),
            "pearson": mt.PearsonCorrCoef(device=device), "spearman": mt.SpearmanCorrCoef(device=device),
        }, device=device)

    card, cpu = collection(cuda), collection("cpu")
    cos_card, cos_cpu = mt.CosineSimilarity(reduction="mean", device=cuda), mt.CosineSimilarity(reduction="mean", device="cpu")
    before = ops.fused_stat_scores_logits.launches, ops.fused_stat_scores.launches
    for part in (slice(0, 1024), slice(1024, 2048), slice(2048, 3000)):
        card.update(p[part, 0].to(cuda), t[part, 0].to(cuda))
        cpu.update(p[part, 0], t[part, 0])
        cos_card.update(p[part].to(cuda), t[part].to(cuda))
        cos_cpu.update(p[part], t[part])
    assert (ops.fused_stat_scores_logits.launches, ops.fused_stat_scores.launches) == before
    assert torch.equal(card["mse"].total.cpu(), cpu["mse"].total) and card["mse"].total.dtype == torch.int32
    assert torch.equal(card["spearman"].buffer_values("preds").cpu(), cpu["spearman"].buffer_values("preds"))
    got, want = card.compute(), cpu.compute()
    for key in want:
        cancels = key in ("r2", "ev", "pearson", "spearman")
        _close_in_units(got[key], want[key], rtol=2.0**-24 * 3000, atol=8 * 2.0**-24 * 3000 if cancels else 0.0)
    _close_in_units(cos_card.compute(), cos_cpu.compute(), rtol=0.0, atol=(3000 + 32) * 2.0**-24)


def retrieval_inputs(n_queries=40, docs=25, seed=31):
    """Whole queries of eighths with ties, signed zeros and NaN; one query without a relevant document."""
    rng = np.random.default_rng(seed)
    ids = np.repeat(rng.permutation(n_queries) * 3 + 1, docs)
    preds = (rng.integers(-8, 9, ids.size) / 8).astype(np.float32)
    preds[rng.random(ids.size) < 0.05] = -0.0
    preds[rng.random(ids.size) < 0.03] = np.nan
    target = (rng.random(ids.size) < 0.2).astype(np.int32)
    target[ids == ids[0]] = 0
    return ids, preds, target


@pytest.mark.cuda
def test_retrieval_engine_on_cuda_orders_as_the_cpu_and_repeats_bitwise(cuda):
    from metrics_tpu_torch.functional.retrieval import engine

    ids, preds, target = (torch.from_numpy(a) for a in retrieval_inputs())
    group, n = engine.contiguous_groups(ids)
    group_card, n_card = engine.contiguous_groups(ids.to(cuda))
    assert n_card == n and torch.equal(group_card.cpu(), group)
    layout = engine._group_layout(preds, group, n)
    layout_card = engine._group_layout(preds.to(cuda), group_card, n)
    for a, b in zip(layout_card, layout):
        assert torch.equal(a.cpu(), b)
    longest = 25 * 2.0**-24
    for name in ("average_precision_per_group", "reciprocal_rank_per_group", "precision_per_group",
                 "recall_per_group", "fall_out_per_group", "hit_rate_per_group", "r_precision_per_group",
                 "ndcg_per_group"):
        fn = getattr(engine, name)
        card = fn(preds.to(cuda), target.to(cuda), group_card, n)
        again = fn(preds.to(cuda), target.to(cuda), group_card, n)
        assert card.cpu().numpy().tobytes() == again.cpu().numpy().tobytes(), name
        assert torch.allclose(card.cpu(), fn(preds, target, group, n), rtol=0, atol=4 * longest), name
    p_card, r_card = engine.precision_recall_curve_per_group(preds.to(cuda), target.to(cuda), group_card, n, max_k=10)
    p_cpu, r_cpu = engine.precision_recall_curve_per_group(preds, target, group, n, max_k=10)
    assert torch.equal(p_card.cpu(), p_cpu) and torch.equal(r_card.cpu(), r_cpu)


@pytest.mark.cuda
def test_retrieval_and_bootstrap_modules_on_cuda_match_the_cpu(cuda):
    ids, preds, target = (torch.from_numpy(a) for a in retrieval_inputs(seed=32))

    def collection(device):
        return mt.MetricCollection({
            "map": mt.RetrievalMAP(device=device), "mrr": mt.RetrievalMRR(device=device),
            "ndcg": mt.RetrievalNormalizedDCG(k=10, device=device),
            "curve": mt.RetrievalPrecisionRecallCurve(max_k=10, device=device),
        }, device=device)

    card, cpu = collection(cuda), collection("cpu")
    for part in (slice(0, 500), slice(500, None)):
        card.update(preds[part].to(cuda), target[part].to(cuda), indexes=ids[part].to(cuda))
        cpu.update(preds[part], target[part], indexes=ids[part])
    got, want = card.compute(), cpu.compute()
    for key, value in want.items():
        for g, w in zip(got[key] if isinstance(got[key], tuple) else (got[key],), value if isinstance(value, tuple) else (value,)):
            assert g.device.type == "cuda" and torch.allclose(g.cpu(), w, rtol=0, atol=65 * 2.0**-24), key
    x = torch.from_numpy((np.random.default_rng(33).integers(-16, 17, (2, 300)) / 8).astype(np.float32))
    boots = [mt.BootStrapper(mt.MeanSquaredError(device=d), num_bootstraps=8, raw=True, device=d) for d in (cuda, "cpu")]
    for b in boots:
        b.update(x[0].to(b.device), x[1].to(b.device))
    assert torch.equal(boots[0].compute()["raw"].cpu(), boots[1].compute()["raw"])


def _sketch_stream(seed: int, size: int) -> np.ndarray:
    """Values with ties, both signed zeros, NaN, both infinities and a tail of whole NaN chunks."""
    rng = np.random.default_rng(seed)
    v = np.round(rng.normal(size=size), 2).astype(np.float32)
    v[::7], v[3::11] = 0.0, -0.0
    v[[1, 2, 4]] = [np.nan, np.inf, -np.inf]
    v[-64:] = np.nan
    return v


def _same_leaves(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].cpu().numpy().tobytes() == b[k].cpu().numpy().tobytes(), k


@pytest.mark.cuda
@pytest.mark.parametrize("capacity,max_items", [(8, 1 << 12), (10, 1 << 10), (256, 1 << 20), (2048, 1 << 26)])
def test_kll_fold_kernel_matches_plain(cuda, capacity, max_items):
    from metrics_tpu_torch.ops import kll
    from metrics_tpu_torch.streaming import sketches as sk

    cpu, card = (sk.kll_init(capacity, seed=2, max_items=max_items, device=d) for d in ("cpu", cuda))
    before = kll.kll_fold.launches
    for step in range(3):
        v = torch.from_numpy(_sketch_stream(step, capacity * 37 + 5))
        cpu, card = sk.kll_update(cpu, v), sk.kll_update(card, v.to(cuda))
    torch.cuda.synchronize()
    assert kll.kll_fold.launches == before + 3
    _same_leaves(cpu, card)
    assert int(card["nc"]) > 0
    empty_cpu, empty_card = (sk.kll_init(capacity, seed=5, max_items=max_items, device=d) for d in ("cpu", cuda))
    _same_leaves(sk.kll_merge([cpu, empty_cpu, cpu]), sk.kll_merge([card, empty_card, card]))
    _same_leaves(sk.kll_merge([empty_cpu, cpu]), sk.kll_merge([empty_card, card]))
    q = torch.tensor([0.01, 0.5, 0.99])
    assert torch.equal(sk.kll_quantile(cpu, q), sk.kll_quantile(card, q.to(cuda)).cpu())


@pytest.mark.cuda
def test_kll_fold_kernel_folds_a_batch_of_sketches_in_one_launch(cuda):
    from metrics_tpu_torch.ops import kll
    from metrics_tpu_torch.streaming import sketches as sk

    sketches = 8
    inits = [sk.kll_init(256, seed=i, max_items=1 << 20, device="cpu") for i in range(sketches)]
    cpu = {k: torch.stack([s[k] for s in inits]) for k in inits[0]}
    card = {k: v.to(cuda) for k, v in cpu.items()}
    values = torch.from_numpy(np.stack([_sketch_stream(10 + i, 5000) for i in range(sketches)]))
    before = kll.kll_fold.launches
    cpu, card = sk.kll_update(cpu, values), sk.kll_update(card, values.to(cuda))
    merged_cpu, merged_card = sk.kll_merge([cpu, cpu]), sk.kll_merge([card, card])
    torch.cuda.synchronize()
    assert kll.kll_fold.launches == before + 2
    _same_leaves(cpu, card)
    _same_leaves(merged_cpu, merged_card)


def _raw_chunks(seed: int, sketches: int, n: int, half: int, case: str):
    """Chunks as ``kll_fold`` takes them: random valid counts (odd ones, short runs), values past them
    +inf; ``padding`` makes most chunks all padding, ``unsorted`` leaves the runs unsorted (the bitonic
    sort), ``nan`` puts a NaN among the valid values (the plain walk sorts it after the padding)."""
    rng = np.random.default_rng(seed)
    valids = rng.integers(1, half + 1, (sketches, n)).astype(np.int32)
    valids[rng.random((sketches, n)) < (0.7 if case == "padding" else 0.1)] = 0
    valids[rng.random((sketches, n)) < 0.05] = -1
    chunks = np.full((sketches, n, half), np.inf, np.float32)
    for s in range(sketches):
        for t in range(n):
            v = max(int(valids[s, t]), 0)
            x = _sketch_stream(seed + 100 * s + t, v + 8)[:v]
            x = np.where(np.isfinite(x), x, np.float32(0.5))
            if case == "nan" and v > 2 and t % 3 == 0:
                x[1] = np.nan
            chunks[s, t, :v] = x if case == "unsorted" else np.sort(x, kind="stable")
    return torch.from_numpy(chunks), torch.from_numpy(valids)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["partial", "padding", "unsorted", "nan", "levels"])
@pytest.mark.parametrize("capacity", [8, 10, 256, 2048])
def test_kll_fold_kernel_on_raw_chunks_matches_plain(cuda, capacity, case):
    """Partial and all-padding chunks (many short runs in a row), unsorted runs, NaN among the valid
    values, and chunks entering at every level (as a merge folds them), into 3 sketches mid-stream."""
    from metrics_tpu_torch.ops import kll
    from metrics_tpu_torch.streaming import sketches as sk

    sketches, half = 3, capacity // 2
    n = max(300, 12_000 // half)
    inits = [sk.kll_update(sk.kll_init(capacity, seed=s, max_items=capacity << 6, device="cpu"),
                           torch.from_numpy(_sketch_stream(s, capacity * 5 + 3))) for s in range(sketches)]
    cpu = {k: torch.stack([st[k] for st in inits]) for k in ("buf", "cnt", "key", "nc")}
    chunks, valids = _raw_chunks(capacity, sketches, n, half, case)
    rng = np.random.default_rng(capacity + 1)
    level_n = cpu["buf"].shape[1]
    levels = torch.from_numpy((rng.integers(0, level_n, n) if case == "levels" else np.zeros(n, np.int64)).astype(np.int32))
    card = {k: v.to(cuda) for k, v in cpu.items()}
    before = kll.kll_fold.launches
    kll.kll_fold(card["buf"], card["cnt"], card["key"], card["nc"], chunks.to(cuda), valids.to(cuda), levels.to(cuda))
    torch.cuda.synchronize()
    assert kll.kll_fold.launches == before + 1
    kll.kll_fold_plain(cpu["buf"], cpu["cnt"], cpu["key"], cpu["nc"], chunks, valids, levels)
    _same_leaves(cpu, card)
    assert int(cpu["nc"].min()) > int(torch.stack([st["nc"] for st in inits]).max())


@pytest.mark.cuda
@pytest.mark.parametrize("capacity,max_items", [(8, 1 << 5), (256, 1 << 11), (2048, 1 << 14)])
def test_kll_fold_kernel_saturates_the_top_level(cuda, capacity, max_items):
    """A stream far past ``max_items``: the top level compacts in place, a chain of events in order."""
    from metrics_tpu_torch.streaming import sketches as sk

    cpu, card = (sk.kll_init(capacity, seed=4, max_items=max_items, device=d) for d in ("cpu", cuda))
    levels = cpu["buf"].shape[0]
    for step in range(2):
        v = torch.from_numpy(_sketch_stream(50 + step, max_items * 3 + 7))
        cpu, card = sk.kll_update(cpu, v), sk.kll_update(card, v.to(cuda))
        torch.cuda.synchronize()
        _same_leaves(cpu, card)
    # a compaction of the top level in place drops weight: the sketch holds less than it was given
    assert int(cpu["cnt"][levels - 1]) > 0 and float(sk.kll_total_weight(cpu)) < int(cpu["n"])


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [10, 256, 2048])
def test_kll_fold_kernel_merges_a_batch_of_8(cuda, capacity):
    """S = 8 sketches updated, then merged slot-wise with two more batches, each fold one launch."""
    from metrics_tpu_torch.ops import kll
    from metrics_tpu_torch.streaming import sketches as sk

    sketches = 8
    inits = [sk.kll_init(capacity, seed=i, max_items=1 << 16, device="cpu") for i in range(sketches)]
    cpu = {k: torch.stack([s[k] for s in inits]) for k in inits[0]}
    values = torch.from_numpy(np.stack([_sketch_stream(60 + i, capacity * 23 + 5) for i in range(sketches)]))
    other = torch.from_numpy(np.stack([_sketch_stream(80 + i, capacity * 7 + 3) for i in range(sketches)]))
    card = {k: v.to(cuda) for k, v in cpu.items()}
    a_cpu, a_card = sk.kll_update(cpu, values), sk.kll_update(card, values.to(cuda))
    b_cpu, b_card = sk.kll_update(cpu, other), sk.kll_update(card, other.to(cuda))
    before = kll.kll_fold.launches
    merged_card = sk.kll_merge([a_card, b_card, a_card])
    torch.cuda.synchronize()
    assert kll.kll_fold.launches == before + 1
    merged_cpu = sk.kll_merge([a_cpu, b_cpu, a_cpu])
    _same_leaves(a_cpu, a_card)
    _same_leaves(merged_cpu, merged_card)


@pytest.mark.cuda
def test_kll_fold_kernel_refuses_rows_wider_than_shared_memory_sorts(cuda):
    from metrics_tpu_torch.ops import kll
    from metrics_tpu_torch.streaming import sketches as sk

    with pytest.raises(ValueError, match=str(kll.MAX_CAPACITY)):
        sk.kll_init(kll.MAX_CAPACITY + 2, device=cuda)
    sk.kll_init(kll.MAX_CAPACITY, max_items=1 << 20, device=cuda)


@pytest.mark.cuda
def test_kll_fold_kernel_refuses_more_levels_than_its_plan_tracks(cuda):
    from metrics_tpu_torch.ops import kll

    levels, k, n = kll.MAX_LEVELS + 1, 8, 2
    buf = torch.full((1, levels, k), float("inf"), device=cuda)
    args = (buf, torch.zeros((1, levels), dtype=torch.int32, device=cuda), torch.zeros((1, 2), dtype=torch.uint32, device=cuda),
            torch.zeros((1,), dtype=torch.int32, device=cuda), torch.zeros((1, n, k // 2), device=cuda),
            torch.ones((1, n), dtype=torch.int32, device=cuda), torch.zeros((n,), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match=str(kll.MAX_LEVELS)):
        kll.kll_fold(*args)


@pytest.mark.cuda
def test_streaming_metrics_on_cuda_equal_the_cpu(cuda):
    made = {}
    for device in ("cpu", cuda):
        made[device] = {
            "q": mt.StreamingQuantile(q=(0.1, 0.5, 0.9), capacity=64, device=device),
            "h": mt.StreamingHistogram(bins=9, capacity=32, device=device),
            "w": mt.WindowedMetric(mt.StreamingQuantile(q=0.5, capacity=16, device=device), window_size=3, device=device),
        }
    for step in range(5):
        v = torch.from_numpy(_sketch_stream(20 + step, 700))
        for device, metrics in made.items():
            for name, m in metrics.items():
                m.update(v.to(device))
            if step % 2:
                metrics["w"].advance()
    for name in ("q", "h", "w"):
        got, want = made[cuda][name].compute(), made["cpu"][name].compute()
        for g, w in zip(*(x.values() if isinstance(x, dict) else (x,) for x in (got, want))):
            assert g.cpu().numpy().tobytes() == w.numpy().tobytes(), name


STREAM_SHAPES = [(1024, 1000, 64), (1024, 1000, 1000), (1000, 7, 1), (0, 5, 3), (513, 33, 5), (2048, 10, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("micro", [False, True])
@pytest.mark.parametrize("n,c,s", STREAM_SHAPES)
def test_stream_stat_scores_kernels_match_plain(cuda, n, c, s, micro):
    """The per-stream entry points against their plain versions: ids out of range on both
    sides, every logits dtype, NaN and tied rows, canonical int32 and bool operands."""
    rng = np.random.default_rng(n + c + s)
    ids = torch.from_numpy(rng.integers(-2, s + 2, n)).to(cuda)
    for dtype, label_dtype in [(torch.float32, torch.int64), (torch.bfloat16, torch.int32), (torch.float16, torch.int64)]:
        logits, labels = logit_cases(n, c, dtype, label_dtype, n + s, cuda)
        for stream_ids in (ids, ids.to(torch.int32)):
            before = ops.fused_stream_stat_scores_logits.launches
            got = ops.fused_stream_stat_scores_logits(logits, labels, stream_ids, s, micro=micro)
            assert ops.fused_stream_stat_scores_logits.launches == before + 1
            want = ops.fused_stream_stat_scores_logits_plain(logits.cpu(), labels.cpu(), stream_ids.cpu(), s, micro)
            assert_counts_equal([g.cpu() for g in got], want)
    for dtype in (torch.int32, torch.bool):
        preds = torch.from_numpy(rng.integers(0, 2, (n, c))).to(device=cuda, dtype=dtype)
        target = torch.from_numpy(rng.integers(0, 2, (n, c))).to(device=cuda, dtype=dtype)
        before = ops.fused_stream_stat_scores.launches
        got = ops.fused_stream_stat_scores(preds, target, ids, s, micro=micro)
        assert ops.fused_stream_stat_scores.launches == before + 1
        assert_counts_equal([g.cpu() for g in got], ops.fused_stream_stat_scores_plain(preds.cpu(), target.cpu(), ids.cpu(), s, micro))


# (n, c, s): C = 1; C not a multiple of 4 with S = 1; clusters of 8 ranks; the large-S branch of the canonical
# route (S past the 501 streams a block holds for int32, 127 or 253 for bool) and logits ranges that loop
# (S * C past two blocks an SM times 2048 outputs); a tall batch for the logits route's phase 2
STREAM_EDGE_SHAPES = [(200, 1, 3), (64, 9, 1), (5000, 40, 6), (1024, 1000, 600), (1024, 64, 5000),
                      (300, 1000, 700), (20_000, 100, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("micro", [False, True])
@pytest.mark.parametrize("n,c,s", STREAM_EDGE_SHAPES)
def test_stream_stat_scores_kernels_match_plain_on_edge_shapes(cuda, n, c, s, micro):
    """Random 0/1 operands (most elements count), int32 and int64 ids and labels out of range on both sides."""
    rng = np.random.default_rng(n + 3 * c + s)
    for k, id_dtype in enumerate((torch.int64, torch.int32)):
        ids = torch.from_numpy(rng.integers(-3, s + 3, n)).to(device=cuda, dtype=id_dtype)
        logits, labels = logit_cases(n, c, torch.float32, (torch.int32, torch.int64)[k], n + k, cuda)
        got = ops.fused_stream_stat_scores_logits(logits, labels, ids, s, micro=micro)
        want = ops.fused_stream_stat_scores_logits_plain(logits.cpu(), labels.cpu(), ids.cpu(), s, micro)
        assert_counts_equal([g.cpu() for g in got], want)
        for dtype in (torch.int32, torch.bool):
            preds = torch.from_numpy(rng.integers(0, 2, (n, c))).to(device=cuda, dtype=dtype)
            target = torch.from_numpy(rng.integers(0, 2, (n, c))).to(device=cuda, dtype=dtype)
            got = ops.fused_stream_stat_scores(preds, target, ids, s, micro=micro)
            want = ops.fused_stream_stat_scores_plain(preds.cpu(), target.cpu(), ids.cpu(), s, micro)
            assert_counts_equal([g.cpu() for g in got], want)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [7, 700])
def test_stream_stat_scores_kernel_counts_values_outside_zero_one(cuda, s):
    rng = np.random.default_rng(s)
    preds = torch.from_numpy(rng.integers(-2, 3, (900, 37)).astype(np.int32)).to(cuda)
    target = torch.from_numpy(rng.integers(-2, 3, (900, 37)).astype(np.int32)).to(cuda)
    ids = torch.from_numpy(rng.integers(-2, s + 2, 900)).to(cuda)
    for micro in (False, True):
        got = ops.fused_stream_stat_scores(preds, target, ids, s, micro=micro)
        assert_counts_equal([g.cpu() for g in got], ops.fused_stream_stat_scores_plain(preds.cpu(), target.cpu(), ids.cpu(), s, micro))


@pytest.mark.cuda
def test_stream_stat_scores_kernels_take_unaligned_rows_and_offsets(cuda):
    """Operands that start 4 or 1 bytes past an aligned address take the narrower loads."""
    rng = np.random.default_rng(12)
    base = torch.from_numpy(rng.integers(0, 2, (257, 65))).to(device=cuda, dtype=torch.int32)
    other = torch.from_numpy(rng.integers(0, 2, (257, 65))).to(device=cuda, dtype=torch.int32)
    ids = torch.from_numpy(rng.integers(0, 9, 256)).to(cuda)
    for dtype in (torch.int32, torch.bool):
        preds, target = base.to(dtype).reshape(-1)[65:].reshape(256, 65), other.to(dtype).reshape(-1)[65:].reshape(256, 65)
        for micro in (False, True):
            got = ops.fused_stream_stat_scores(preds, target, ids, 9, micro=micro)
            assert_counts_equal([g.cpu() for g in got], ops.fused_stream_stat_scores_plain(preds.cpu(), target.cpu(), ids.cpu(), 9, micro))


@pytest.mark.cuda
def test_stream_stat_scores_kernel_all_rows_in_one_stream(cuda):
    logits, labels = logit_cases(1024, 1000, torch.float32, torch.int64, 3, cuda)
    ids = torch.zeros(1024, dtype=torch.int64, device=cuda)
    for micro in (False, True):
        got = ops.fused_stream_stat_scores_logits(logits, labels, ids, 64, micro=micro)
        assert_counts_equal([g.cpu() for g in got], ops.fused_stream_stat_scores_logits_plain(logits.cpu(), labels.cpu(), ids.cpu(), 64, micro))
        total = ops.fused_stat_scores_logits(logits, labels)
        for g, t in zip(got, total):
            assert torch.equal(g[0], t.sum() if micro else t)


@pytest.mark.cuda
def test_multistream_stat_scores_on_cuda_come_from_the_kernel(cuda):
    from metrics_tpu_torch.multistream import MultiStreamMetric

    logits, labels = logit_cases(512, 100, torch.float32, torch.int64, 4, cuda)
    labels = labels.clamp(0, 99)  # the metric's validation refuses labels out of range
    ids = labels % 16
    made = {d: MultiStreamMetric(mt.F1Score(num_classes=100, average="macro", device=d), num_streams=16, device=d) for d in ("cpu", cuda)}
    before = (ops.fused_stream_stat_scores_logits.launches, ops.fused_stat_scores_logits.launches)
    made[cuda].update(logits, labels, stream_ids=ids)
    assert (ops.fused_stream_stat_scores_logits.launches, ops.fused_stat_scores_logits.launches) == (before[0] + 1, before[1])
    made["cpu"].update(logits.cpu(), labels.cpu(), stream_ids=ids.cpu())
    for name in ("tp", "fp", "tn", "fn", "stream_rows"):
        assert torch.equal(getattr(made[cuda], name).cpu(), getattr(made["cpu"], name)), name


@pytest.mark.cuda
def test_kll_fold_kernel_folds_1000_stacked_sketches_in_one_launch(cuda):
    """A multistream quantile's update: one kll_fold call over 1,000 stacked sketches."""
    from metrics_tpu_torch.multistream import MultiStreamMetric
    from metrics_tpu_torch.ops import kll

    rng = np.random.default_rng(6)
    made = {d: MultiStreamMetric(mt.StreamingQuantile(q=(0.5, 0.9), capacity=64, max_items=1 << 16, device=d), num_streams=1000, device=d)
            for d in ("cpu", cuda)}
    for step in range(2):
        values = torch.from_numpy(_sketch_stream(30 + step, 50_000))
        ids = torch.from_numpy(rng.integers(0, 1000, 50_000))
        before = kll.kll_fold.launches
        made[cuda].update(values.to(cuda), stream_ids=ids.to(cuda))
        assert kll.kll_fold.launches == before + 1
        made["cpu"].update(values, stream_ids=ids)
    got = {k: v for k, v in made[cuda].state_pytree().items() if k != "_update_count"}
    want = {k: v for k, v in made["cpu"].state_pytree().items() if k != "_update_count"}
    _same_leaves(got, want)
    assert made[cuda].compute().cpu().numpy().tobytes() == made["cpu"].compute().numpy().tobytes()


@pytest.mark.cuda
def test_multistream_histogram_on_cuda_equals_the_cpu(cuda):
    """A per-stream histogram's update (one kll_fold over the stacked sketches) and compute, bitwise as on the CPU."""
    from metrics_tpu_torch.multistream import MultiStreamMetric
    from metrics_tpu_torch.ops import kll

    rng = np.random.default_rng(7)
    made = {d: MultiStreamMetric(mt.StreamingHistogram(bins=20, capacity=32, max_items=1 << 14, device=d), num_streams=50, device=d)
            for d in ("cpu", cuda)}
    for step in range(3):
        values = torch.from_numpy(_sketch_stream(40 + step, 4000))
        ids = torch.from_numpy(rng.integers(-1, 49, 4000))  # stream 49 stays empty, -1 is dropped
        before = kll.kll_fold.launches
        made[cuda].update(values.to(cuda), stream_ids=ids.to(cuda))
        assert kll.kll_fold.launches == before + 1
        made["cpu"].update(values, stream_ids=ids)
    got = {k: v for k, v in made[cuda].state_pytree().items() if k != "_update_count"}
    want = {k: v for k, v in made["cpu"].state_pytree().items() if k != "_update_count"}
    _same_leaves(got, want)
    card, cpu = made[cuda].compute(), made["cpu"].compute()
    for k in ("edges", "counts"):
        got, want = card[k].cpu().numpy(), cpu[k].numpy()
        # the empty stream's edges are inf - inf: NaN on both, with the card's own NaN bits (0x7fffffff)
        assert (np.isnan(got) == np.isnan(want)).all() and np.isnan(got).sum() == (k == "edges") * 21, k
        assert got[~np.isnan(got)].tobytes() == want[~np.isnan(want)].tobytes(), k


# ------------------------------------------------- the rest of the core
@pytest.mark.cuda
def test_async_sync_on_cuda_states_equals_the_synchronous_twin(cuda):
    """A round's snapshot is read on the worker's side stream after the
    caller's kernels, and its results are used on the caller's stream."""
    import time

    import metrics_tpu_torch.parallel as tp

    chaos = tp.ChaosBackend(tp.LoopbackBackend(), packed=True, stall_secs=0.05)
    m = mt.CatMetric(sync_backend=chaos, device=cuda)
    q = mt.StreamingQuantile(q=0.5, capacity=8, max_items=1 << 9, sync_backend=tp.LoopbackBackend(), device=cuda)
    twin = mt.CatMetric(sync_backend=tp.LoopbackBackend(), device=cuda)
    q_twin = mt.StreamingQuantile(q=0.5, capacity=8, max_items=1 << 9, sync_backend=tp.LoopbackBackend(), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    for step in range(4):
        rows = torch.rand(4096, generator=gen, device=cuda) * (step + 1)
        m.update(rows)
        q.update(rows)
        twin.update(rows)
        q_twin.update(rows)
        start = time.perf_counter()
        handles = m.sync_async(), q.sync_async()
        submit_secs = time.perf_counter() - start
        assert submit_secs < 0.1, f"step {step}: two submits took {submit_secs} s"
        assert None not in handles
        twin.compute()
        twin._computed = None
        for handle in handles:  # a submit folds the previous round, waiting for it if it still runs
            handle.wait()
    value, twin_value = m.compute(), twin.compute()
    assert value.device.type == "cuda" and torch.equal(value, twin_value), (value.shape, twin_value.shape)
    estimate, twin_estimate = q.compute(), q_twin.compute()
    assert torch.equal(estimate, twin_estimate), (estimate, twin_estimate)


@pytest.mark.cuda
def test_a_cuda_metric_makes_its_side_stream_when_it_takes_the_device(cuda, monkeypatch):
    """A process's first stream makes PyTorch's stream pools (tens of ms): a metric that may
    run async rounds makes its side stream at construction or ``to_device``, not at a submit."""
    import metrics_tpu_torch.metric as core

    monkeypatch.setattr(core, "_WORKER_STREAMS", {})
    mt.CatMetric(device=cuda, async_sync=False)
    assert not core._WORKER_STREAMS
    m = mt.CatMetric(device="cpu")
    assert not core._WORKER_STREAMS
    m.to_device(cuda)
    assert list(core._WORKER_STREAMS) == [m.device]
    stream = core._WORKER_STREAMS[m.device]
    mt.CatMetric(device=cuda)
    assert core._WORKER_STREAMS == {m.device: stream}


@pytest.mark.cuda
def test_bf16_states_on_cuda_equal_the_cpu(cuda):
    rng = np.random.default_rng(1)
    preds, target = rng.random((4, 4096), dtype=np.float32), rng.random((4, 4096), dtype=np.float32)
    out = {}
    for device in ("cpu", cuda):
        m = mt.MeanSquaredError(device=device)
        for p, t in zip(preds, target):
            m.update(torch.from_numpy(p).to(device), torch.from_numpy(t).to(device))
        m.half()
        assert m.sum_squared_error.dtype == torch.bfloat16 and m.total.dtype == torch.int32
        out[str(device)] = (m.sum_squared_error.cpu(), m.compute().cpu())
    cpu, card = out["cpu"], out[str(cuda)]
    assert card[1].dtype == torch.bfloat16
    # float32 sums of another order, then one rounding to bf16: within one bf16 ulp
    for a, b in zip(card, cpu):
        torch.testing.assert_close(a.float(), b.float(), rtol=2.0**-8, atol=0)


@pytest.mark.cuda
def test_composition_on_cuda_equals_the_cpu(cuda):
    rng = np.random.default_rng(2)
    batches = [(rng.random((512, 10), dtype=np.float32), rng.integers(0, 10, 512)) for _ in range(3)]
    out = {}
    for device in ("cpu", cuda):
        comps = [
            (mt.F1Score(num_classes=10, average="macro", device=device) + mt.Accuracy(num_classes=10, device=device)) / 2,
            -mt.Precision(num_classes=10, average="macro", device=device),
            mt.Accuracy(num_classes=10, average=None, device=device)[7],
        ]
        steps = []
        for p, t in batches:
            steps.append([c(torch.from_numpy(p).to(device), torch.from_numpy(t).to(device)).cpu() for c in comps])
        steps.append([c.compute().cpu() for c in comps])
        out[str(device)] = steps
    # acc(None)[7] is a ratio of integer counts: bitwise (a NaN where a batch has no class 7, by position);
    # the macro means sum ten class scores in an order the device picks: within C x 2^-24 relative
    for a_step, b_step in zip(out[str(cuda)], out["cpu"]):
        for i, (a, b) in enumerate(zip(a_step, b_step)):
            assert a.dtype == b.dtype and bool(torch.isnan(a)) == bool(torch.isnan(b))
            if i == 2:
                assert torch.isnan(a) or torch.equal(a, b)
            else:
                torch.testing.assert_close(a, b, rtol=10 * 2.0**-24, atol=0)


def _rank_blocks(b, d, g, seed, levels=4, areas=4, thresholds=10, lowest=0):
    """IoU ranks on a coarse grid (ties everywhere) with padded slots, rows and columns, ignore flags and
    threshold ranks from ``lowest`` up (-1 makes padded slots eligible)."""
    rng = np.random.default_rng(seed)
    ranks = rng.integers(0, levels + 1, (b, d, g)).astype(np.int32)
    ranks[rng.random((b, d, g)) < 0.2] = -1
    ranks[:, :, g - g // 4:] = -1  # padded gt columns
    ranks[:, d - d // 3:, :] = -1  # padded det rows
    ranks[::3, :, :] = -1  # all-padding blocks
    gig = rng.random((areas, b, g)) < 0.3
    thr = np.sort(rng.integers(lowest, levels + 1, thresholds)).astype(np.int32)
    return (torch.from_numpy(ranks), torch.from_numpy(gig), torch.from_numpy(thr))


@pytest.mark.cuda
@pytest.mark.parametrize("lowest", [0, -1])
@pytest.mark.parametrize("b,d,g", [(300, 112, 8), (40, 16, 33), (7, 9, 1100), (5, 4, 0), (0, 3, 3)])
def test_coco_match_kernel_is_bitwise_its_plain_version(cuda, b, d, g, lowest):
    from metrics_tpu_torch.ops import coco_match as cm

    ranks, gig, thr = _rank_blocks(b, d, g, seed=b + d + g, lowest=lowest)
    want = cm.coco_match_plain(ranks, gig, thr)
    before = cm.coco_match.launches
    got = cm.coco_match(ranks.to(cuda), gig.to(cuda), thr.to(cuda))
    torch.cuda.synchronize()
    assert got.dtype == torch.uint8 and torch.equal(got.cpu(), want)
    assert cm.coco_match.launches == before + (1 if got.numel() else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_map_device_route_on_cuda_equals_the_cpu(cuda, iou_type):
    rng = np.random.default_rng(3)
    preds, targets = [], []
    for _ in range(20):
        n_g, n_p = int(rng.integers(1, 6)), int(rng.integers(0, 9))
        gl = rng.integers(0, 4, n_g)
        idx = rng.integers(0, n_g, max(n_p, 1))[:n_p]
        if iou_type == "bbox":
            gb = np.stack([rng.integers(0, 50, n_g), rng.integers(0, 50, n_g),
                           rng.integers(55, 90, n_g), rng.integers(55, 90, n_g)], 1).astype(np.float32)
            item, pitem = gb, np.clip(gb[idx] + rng.integers(-8, 9, (n_p, 4)), 0, 100).astype(np.float32)
        else:
            item = np.zeros((n_g, 40, 48), np.uint8)
            for j in range(n_g):
                y0, x0 = int(rng.integers(0, 34)), int(rng.integers(0, 42))
                item[j, y0 : y0 + int(rng.integers(2, 14)), x0 : x0 + int(rng.integers(2, 14))] = 1
            pitem = np.roll(item[idx], 2, axis=2)
        key = "boxes" if iou_type == "bbox" else "masks"
        preds.append({key: pitem, "scores": rng.random(n_p).astype(np.float32), "labels": gl[idx]})
        targets.append({key: item, "labels": gl})
    out = {}
    for device in ("cpu", cuda):
        moved = lambda ds: [{k: torch.from_numpy(np.asarray(v)).to(device) for k, v in d.items()} for d in ds]  # noqa: E731
        m = mt.MeanAveragePrecision(iou_type=iou_type, on_device=True, device=device)
        m.update(moved(preds), moved(targets))
        out[str(device)] = {k: v.cpu() for k, v in m.compute().items()}
    for key, value in out["cpu"].items():
        assert torch.equal(out[str(cuda)][key], value), key


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["structural_similarity_index_measure", "universal_image_quality_index",
                                  "spectral_distortion_index", "multiscale_structural_similarity_index_measure"])
@pytest.mark.parametrize("tf32", [True, False])
def test_image_convolutions_on_cuda_stay_float32_with_tf32_allowed(cuda, name, tf32):
    from metrics_tpu_torch.functional import image as fi

    rng = np.random.default_rng(4)
    preds = rng.random((2, 3, 192, 192)).astype(np.float32)
    target = np.clip(0.8 * preds + 0.1 * rng.random(preds.shape), 0, 1).astype(np.float32)
    fn = getattr(fi, name)
    want = fn(torch.from_numpy(preds), torch.from_numpy(target))
    before = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = tf32
        got = fn(torch.from_numpy(preds).to(cuda), torch.from_numpy(target).to(cuda)).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = before
    # float32 window sums in another order than the CPU's: a few ulps, magnified by the variance's cancellation
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_bertscore_matching_on_cuda_equals_the_cpu(cuda):
    """The greedy matching from identical embeddings, per layer too, within 1e-6 of the CPU's."""
    from metrics_tpu_torch.functional.text.bert import _greedy_match

    gen = torch.Generator().manual_seed(0)
    emb = torch.randn(3, 8, 40, 64, generator=gen)  # (layers, pairs x 2 sides, tokens, dim)
    lens = torch.randint(1, 41, (8,), generator=gen)
    mask = (torch.arange(40)[None, :] < lens[:, None]).float()
    weights = torch.rand(8, 40, generator=gen)
    args = (emb[:, :4], mask[:4], emb[:, 4:], mask[4:], weights[:4], weights[4:])
    cpu = _greedy_match(*args)
    card = _greedy_match(*(a.to(cuda) for a in args))
    for key in cpu:
        assert card[key].device.type == "cuda" and card[key].shape == (3, 4)
        assert float((card[key].cpu() - cpu[key]).abs().max()) <= 1e-6, key
    one = _greedy_match(*(a[0] if a.ndim == 4 else a for a in (a.to(cuda) for a in args)))
    assert torch.allclose(one["f1"].cpu(), cpu["f1"][0], atol=1e-6, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kwargs", [{"filter_length": 512}, {"filter_length": 64, "zero_mean": True, "load_diag": 1e-3}])
def test_sdr_on_cuda_equals_the_cpu(cuda, kwargs):
    from metrics_tpu_torch.functional.audio.sdr import signal_distortion_ratio

    rng = np.random.default_rng(1)
    target = rng.standard_normal((6, 8000)).astype(np.float32)
    target[:, 1:] += 0.8 * target[:, :-1]
    preds = (0.9 * target + 0.3 * rng.standard_normal((6, 8000))).astype(np.float32)
    cpu = signal_distortion_ratio(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    card = signal_distortion_ratio(torch.from_numpy(preds).to(cuda), torch.from_numpy(target).to(cuda), **kwargs)
    assert card.device.type == "cuda" and card.dtype == torch.float32
    assert float((card.cpu() - cpu).abs().max()) <= 2e-3  # dB: float32 FFTs and solve, reordered
    metric = mt.SignalDistortionRatio(device="cuda", **kwargs)
    metric.update(torch.from_numpy(preds).to(cuda), torch.from_numpy(target).to(cuda))
    assert metric.sum_sdr.device.type == "cuda" and int(metric.total) == 6


@pytest.mark.cuda
def test_serve_blocks_on_cuda_equal_a_direct_update(cuda):
    """One padded multistream block and one pow2 tail ingested on the card: each
    job's state bitwise that of a twin updated directly with the same pieces,
    the per-stream and plain logits kernels launched once a piece."""
    from metrics_tpu_torch.serve import BlockBatcher, MetricRegistry

    rng = np.random.default_rng(16)
    n, c, s = 37, 10, 6
    logits = rng.standard_normal((n, c)).astype(np.float32)
    labels = rng.integers(0, c, n)
    ids = rng.integers(-1, s + 1, n).astype(np.int32)
    reg = MetricRegistry()
    reg.register("top1", mt.Accuracy(num_classes=c, device="cuda"))
    reg.register("per_class", mt.MultiStreamMetric(mt.Accuracy(num_classes=c, device="cuda"), num_streams=s, device="cuda"))
    ops.fused_stat_scores_logits.launches = ops.fused_stream_stat_scores_logits.launches = 0
    b_plain, b_stream = BlockBatcher(reg["top1"], block_rows=64), BlockBatcher(reg["per_class"], block_rows=64)
    b_plain.extend_columns([logits, labels])
    b_stream.extend_columns([logits, labels], ids)
    assert ops.fused_stat_scores_logits.launches == ops.fused_stream_stat_scores_logits.launches == 0  # 37 < 64: carried
    assert b_plain.flush() == n and b_stream.flush() == n
    assert ops.fused_stat_scores_logits.launches == 3  # 32 + 4 + 1: the pow2 chunks of 37 rows
    assert ops.fused_stream_stat_scores_logits.launches == 1  # one block padded from 37 to 64 rows
    plain = mt.Accuracy(num_classes=c, device="cuda")
    x, y = torch.from_numpy(logits).to(cuda), torch.from_numpy(labels).to(cuda)
    for lo, hi in ((0, 32), (32, 36), (36, 37)):
        plain.update(x[lo:hi], y[lo:hi])
    stream = mt.MultiStreamMetric(mt.Accuracy(num_classes=c, device="cuda"), num_streams=s, device="cuda")
    pad_ids = torch.full((64,), -1, dtype=torch.int32, device=cuda)
    pad_ids[:n] = torch.from_numpy(ids).to(cuda)
    stream.update(torch.cat([x, x.new_zeros((64 - n, c))]), torch.cat([y, y.new_zeros((64 - n,))]),
                  stream_ids=pad_ids, num_valid=torch.tensor([n], dtype=torch.int32, device=cuda))
    for got, want in ((reg["top1"].metric, plain), (reg["per_class"].metric, stream)):
        for key in want._defaults:
            a, b = getattr(got, key), getattr(want, key)
            assert a.device.type == "cuda" and torch.equal(a, b), key
    assert reg["per_class"].metric.dropped_rows() == int(((ids < 0) | (ids >= s)).sum())
    assert float(reg["top1"].compute()) == float(plain.compute())
