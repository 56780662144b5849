"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and ``nvcc``; without them they skip.  They
import neither JAX nor ``metrics_tpu``, so on a machine without JAX they run
without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

import metrics_tpu_torch as mt
from metrics_tpu_torch.ops import stat_scores as ops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.bool])
@pytest.mark.parametrize("n,c", [(1024, 1000), (848, 1000), (3, 5), (0, 4), (4096, 4097)])
def test_stat_scores_kernel_matches_plain(cuda, n, c, dtype):
    gen = torch.Generator(device=cuda).manual_seed(n + c)
    preds = torch.randint(0, 2, (n, c), device=cuda, generator=gen).to(dtype)
    target = torch.randint(0, 2, (n, c), device=cuda, generator=gen).to(dtype)
    before = ops.fused_stat_scores.launches
    got = ops.fused_stat_scores(preds, target)
    torch.cuda.synchronize()
    assert ops.fused_stat_scores.launches == before + 1
    for g, e in zip(got, ops.fused_stat_scores_plain(preds, target)):
        assert g.dtype == torch.int32
        assert torch.equal(g, e)


@pytest.mark.cuda
def test_macro_metrics_on_cuda_go_through_the_kernel(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    preds = torch.rand((300, 12), device=cuda, generator=gen)
    target = torch.randint(0, 12, (300,), device=cuda, generator=gen)
    metric = mt.F1Score(num_classes=12, average="macro")
    reference = mt.F1Score(num_classes=12, average="macro", device="cpu")
    before = ops.fused_stat_scores.launches
    metric.update(preds, target)
    reference.update(preds.cpu(), target.cpu())
    assert ops.fused_stat_scores.launches == before + 1
    for state in ("tp", "fp", "tn", "fn"):
        assert torch.equal(getattr(metric, state).cpu(), getattr(reference, state))
    torch.testing.assert_close(metric.compute().cpu(), reference.compute(), rtol=1e-6, atol=1e-7)
    with pytest.raises(RuntimeError, match="keeps its state on"):
        metric.update(preds.cpu(), target.cpu())
