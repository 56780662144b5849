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
