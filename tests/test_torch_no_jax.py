"""The port stands alone: no JAX, nothing of ``metrics_tpu``, and no silent fall-back to the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import metrics_tpu_torch as mt

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "metrics_tpu")


def _port_sources():
    return sorted((ROOT / "metrics_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "tools" / "port_device_probe.py"]


def test_the_walk_covers_the_sync_modules_and_the_aggregators():
    walked = {p.relative_to(ROOT).as_posix() for p in _port_sources()}
    assert {
        "metrics_tpu_torch/aggregation.py",
        "metrics_tpu_torch/parallel/__init__.py",
        "metrics_tpu_torch/parallel/backend.py",
        "metrics_tpu_torch/parallel/faults.py",
    } <= walked


CURVE_SLICE = ("auc", "auroc", "precision_recall_curve", "roc", "specificity", "dice", "hamming")


def test_the_walk_covers_the_curve_and_stat_derivative_modules():
    walked = {p.relative_to(ROOT).as_posix() for p in _port_sources()}
    expected = {f"metrics_tpu_torch/functional/classification/{name}.py" for name in CURVE_SLICE + ("average_precision",)}
    expected |= {f"metrics_tpu_torch/classification/{name}.py" for name in CURVE_SLICE + ("avg_precision", "binned_precision_recall")}
    assert expected <= walked


REST_OF_CLASSIFICATION = ("jaccard", "matthews_corrcoef", "cohen_kappa", "hinge", "kl_divergence", "calibration_error", "ranking")


def test_the_walk_covers_the_rest_of_classification():
    walked = {p.relative_to(ROOT).as_posix() for p in _port_sources()}
    expected = {f"metrics_tpu_torch/{layer}/{name}.py" for name in REST_OF_CLASSIFICATION
                for layer in ("classification", "functional/classification")}
    assert len(expected) == 14 and expected <= walked


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_importing_the_port_loads_neither_jax_nor_metrics_tpu():
    code = (
        "import sys, metrics_tpu_torch\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'metrics_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_port_source_imports_jax_or_metrics_tpu(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_construction_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mt.Accuracy(num_classes=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mt.MetricCollection([mt.Accuracy(num_classes=3, device="cpu")])
    assert mt.Accuracy(num_classes=3, device="cpu").device == torch.device("cpu")
