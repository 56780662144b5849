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
