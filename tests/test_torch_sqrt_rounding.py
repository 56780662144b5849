"""The port's square root is correctly rounded on the CPU, as ``jnp.sqrt`` and numpy's are.

Some CPU builds of PyTorch compute a float32 ``torch.sqrt`` a unit in the last
place off the correctly rounded root on a sixth of all inputs, whatever
``ATEN_CPU_CAPABILITY`` says; the eighths parity tests (RMSE, the euclidean
pairwise distance) then part from the JAX package by one ulp.
``metrics_tpu_torch.utils.compute._sqrt`` takes a CPU float32 root in float64
and rounds once, which is exact.  Held here bitwise against numpy's float32
``sqrt`` on 200,000 multiples of 1/8 and on random float32 values across the
exponent range, in this process and, where the CPU has AVX-512, in a
subprocess that forces ATen's AVX-512 kernels.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from metrics_tpu_torch.utils.compute import _norm, _sqrt

ROOT = Path(__file__).resolve().parents[1]


def _eighths() -> np.ndarray:
    return np.arange(1, 200_001, dtype=np.float32) / np.float32(8)


def _spread(seed: int = 0, n: int = 200_000) -> np.ndarray:
    """Positive float32 values with exponents from 2**-126 to 2**127, plus 0, subnormals and inf."""
    rng = np.random.default_rng(seed)
    bits = (rng.integers(1, 254, n, dtype=np.uint32) << 23) | rng.integers(0, 1 << 23, n, dtype=np.uint32)
    specials = np.array([0.0, np.float32(1e-45), np.float32(3e-39), np.inf], dtype=np.float32)
    return np.concatenate([bits.view(np.float32), specials])


def _bit_mismatches(values: np.ndarray) -> int:
    got = _sqrt(torch.from_numpy(values)).numpy()
    return int((got.view(np.int32) != np.sqrt(values).view(np.int32)).sum())


@pytest.mark.parametrize("values", [_eighths(), _spread()], ids=["eighths", "exponents"])
def test_sqrt_is_numpys_float32_sqrt_bitwise(values):
    assert _bit_mismatches(values) == 0


def test_sqrt_of_negative_and_nan_is_nan():
    got = _sqrt(torch.tensor([-1.0, float("nan"), -0.0]))
    assert torch.isnan(got[:2]).all() and got[2].item() == 0.0 and str(got.dtype) == "torch.float32"


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_half_precision_roots_round_once_from_float64(dtype):
    x = torch.from_numpy(_eighths()[:4096]).to(dtype)
    want = torch.from_numpy(np.sqrt(x.double().numpy())).to(dtype)
    got = _sqrt(x)
    assert got.dtype == dtype and torch.equal(got, want)


def test_norm_is_the_rounded_root_of_the_float32_sum_of_squares():
    rng = np.random.default_rng(3)
    x = (rng.integers(-64, 64, size=(300, 17)) / 8).astype(np.float32)
    sq = (x * x).sum(-1, dtype=np.float32)  # exact: multiples of 1/64 below 2**24
    got = _norm(torch.from_numpy(x), -1).numpy()
    assert got.tobytes() == np.sqrt(sq).tobytes()
    assert _norm(torch.from_numpy(x), -1, keepdim=True).shape == (300, 1)


def test_sqrt_keeps_the_gradient():
    x = torch.tensor([4.0, 2.0], requires_grad=True)
    _sqrt(x).sum().backward()
    assert torch.allclose(x.grad, 0.5 / torch.sqrt(torch.tensor([4.0, 2.0])))


def test_sqrt_under_forced_avx512_kernels():
    if "AVX512" not in torch.backends.cpu.get_cpu_capability():
        pytest.skip("this CPU has no AVX-512")
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "import numpy as np, torch\n"
        "from metrics_tpu_torch.utils.compute import _sqrt\n"
        "assert torch.backends.cpu.get_cpu_capability() == 'AVX512'\n"
        "x = np.arange(1, 200001, dtype=np.float32) / np.float32(8)\n"
        "got = _sqrt(torch.from_numpy(x)).numpy()\n"
        "print(int((got.view(np.int32) != np.sqrt(x).view(np.int32)).sum()))\n"
    )
    env = dict(os.environ, ATEN_CPU_CAPABILITY="avx512")
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "0"
