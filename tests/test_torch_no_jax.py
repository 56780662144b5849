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
        "metrics_tpu_torch/obs/__init__.py",
        "metrics_tpu_torch/obs/core.py",
        "metrics_tpu_torch/obs/exporters.py",
        "metrics_tpu_torch/obs/logging.py",
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


REGRESSION = ("mse", "mae", "log_mse", "mape", "symmetric_mape", "wmape", "tweedie_deviance", "explained_variance",
              "r2", "pearson", "cosine_similarity", "spearman")
PAIRWISE = ("helpers", "linear", "cosine", "euclidean", "manhattan")


def test_the_walk_covers_regression_and_pairwise():
    walked = {p.relative_to(ROOT).as_posix() for p in _port_sources()}
    expected = {f"metrics_tpu_torch/{layer}/{name}.py" for name in REGRESSION for layer in ("regression", "functional/regression")}
    expected |= {f"metrics_tpu_torch/functional/pairwise/{name}.py" for name in PAIRWISE}
    assert len(expected) == 29 and expected <= walked


WRAPPERS = ("bootstrapping", "classwise", "minmax", "multioutput", "tracker", "_resample")
RETRIEVAL = ("average_precision", "fall_out", "hit_rate", "ndcg", "precision", "precision_recall_curve",
             "r_precision", "recall", "reciprocal_rank")


def test_the_walk_covers_the_wrappers_and_retrieval():
    walked = {p.relative_to(ROOT).as_posix() for p in _port_sources()}
    expected = {f"metrics_tpu_torch/wrappers/{name}.py" for name in WRAPPERS}
    expected |= {f"metrics_tpu_torch/{layer}/{name}.py" for name in RETRIEVAL for layer in ("retrieval", "functional/retrieval")}
    expected |= {"metrics_tpu_torch/retrieval/base.py", "metrics_tpu_torch/functional/retrieval/engine.py"}
    assert len(expected) == 26 and expected <= walked


STREAMING = ("metrics_tpu_torch/streaming/__init__.py", "metrics_tpu_torch/streaming/_threefry.py",
             "metrics_tpu_torch/streaming/sketches.py", "metrics_tpu_torch/streaming/quantile.py",
             "metrics_tpu_torch/streaming/window.py", "metrics_tpu_torch/ops/kll.py", "metrics_tpu_torch/ops/_build.py")


def test_the_walk_covers_the_streaming_modules_and_the_kll_fold():
    walked = {p.relative_to(ROOT).as_posix() for p in _port_sources()}
    assert set(STREAMING) <= walked
    assert (ROOT / "metrics_tpu_torch" / "ops" / "csrc" / "kll_fold.cu").is_file()


def test_sketch_functions_without_device_raise_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (mt.kll_init, mt.reservoir_init, mt.StreamingQuantile, mt.StreamingHistogram):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    for wrap in (mt.WindowedMetric, mt.TimeDecayedMetric):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            wrap(mt.SumMetric(device="cpu"), 2)
    assert mt.kll_init(8, device="cpu")["buf"].device == torch.device("cpu")


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
    for make in (mt.MeanSquaredError, mt.PearsonCorrCoef, mt.SpearmanCorrCoef, mt.R2Score):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert mt.Accuracy(num_classes=3, device="cpu").device == torch.device("cpu")


def test_wrappers_and_retrieval_without_device_raise_when_cuda_is_absent(monkeypatch):
    base = mt.MeanSquaredError(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: mt.BootStrapper(base), lambda: mt.MinMaxMetric(base), lambda: mt.ClasswiseWrapper(base),
                 lambda: mt.MultioutputWrapper(base, num_outputs=2), mt.RetrievalMAP, mt.RetrievalMRR,
                 mt.RetrievalNormalizedDCG, mt.RetrievalPrecisionRecallCurve):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert mt.BootStrapper(base, device="cpu").device == torch.device("cpu")


CHECKPOINT_AND_MULTISTREAM = tuple(
    f"metrics_tpu_torch/{pkg}/{name}.py"
    for pkg, names in (("checkpoint", ("__init__", "codec", "store", "manager")), ("multistream", ("__init__", "core", "sharding")))
    for name in names
)


def test_the_walk_covers_the_checkpoint_and_multistream_modules():
    walked = {p.relative_to(ROOT).as_posix() for p in _port_sources()}
    assert len(CHECKPOINT_AND_MULTISTREAM) == 7 and set(CHECKPOINT_AND_MULTISTREAM) <= walked


def test_multistream_without_device_raises_when_cuda_is_absent(monkeypatch):
    base = mt.Accuracy(num_classes=3, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mt.MultiStreamMetric(base, num_streams=2)
    assert mt.MultiStreamMetric(base, num_streams=2, device="cpu").device == torch.device("cpu")


DETECTION_AND_IMAGE = (
    ["metrics_tpu_torch/utils/imports.py", "metrics_tpu_torch/_native/__init__.py", "metrics_tpu_torch/ops/coco_match.py"]
    + [f"metrics_tpu_torch/detection/{name}.py" for name in ("__init__", "device", "mean_ap")]
    + [f"metrics_tpu_torch/functional/image/{name}.py"
       for name in ("__init__", "helper", "psnr", "ssim", "uqi", "ergas", "sam", "d_lambda", "gradients")]
    + [f"metrics_tpu_torch/image/{name}.py" for name in ("__init__", "psnr", "ssim", "uqi", "ergas", "sam", "d_lambda")]
)


def test_the_walk_covers_detection_the_native_library_and_image():
    walked = {p.relative_to(ROOT).as_posix() for p in _port_sources()}
    assert len(DETECTION_AND_IMAGE) == 22 and set(DETECTION_AND_IMAGE) <= walked
    assert (ROOT / "metrics_tpu_torch" / "ops" / "csrc" / "coco_match.cu").is_file()
    assert (ROOT / "metrics_tpu_torch" / "_native" / "native.cpp").is_file()


def test_detection_and_image_without_device_raise_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (mt.MeanAveragePrecision, mt.PeakSignalNoiseRatio, mt.StructuralSimilarityIndexMeasure,
                 mt.MultiScaleStructuralSimilarityIndexMeasure, mt.UniversalImageQualityIndex,
                 mt.ErrorRelativeGlobalDimensionlessSynthesis, mt.SpectralAngleMapper, mt.SpectralDistortionIndex):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert mt.MeanAveragePrecision(device="cpu").device == torch.device("cpu")


GENERATION_AND_TEXT = (
    ["metrics_tpu_torch/image/_batching.py"]
    + [f"metrics_tpu_torch/image/backbones/{name}.py" for name in ("__init__", "inception", "weights", "convert")]
    + [f"metrics_tpu_torch/image/{name}.py" for name in ("fid", "kid", "inception", "lpip")]
    + [f"metrics_tpu_torch/{layer}/{name}.py" for layer in ("functional/text", "text")
       for name in ("__init__", "wer", "cer", "mer", "wil", "wip")]
    + ["metrics_tpu_torch/functional/text/helper.py"]
)


def test_the_walk_covers_the_extractor_metrics_their_backbones_and_the_wer_family():
    walked = {p.relative_to(ROOT).as_posix() for p in _port_sources()}
    assert len(GENERATION_AND_TEXT) == 22 and set(GENERATION_AND_TEXT) <= walked


TEXT_AND_AUDIO = (
    [f"metrics_tpu_torch/{layer}/{name}.py" for layer in ("functional/text", "text")
     for name in ("ter", "eed", "bleu", "sacre_bleu", "chrf", "rouge", "squad", "bert")]
    + ["metrics_tpu_torch/functional/text/wordpiece.py", "metrics_tpu_torch/audio/_base.py"]
    + [f"metrics_tpu_torch/{layer}/{name}.py" for layer in ("functional/audio", "audio")
       for name in ("__init__", "snr", "sdr", "pit", "pesq", "stoi")]
)


def test_the_walk_covers_the_rest_of_text_and_audio():
    walked = {p.relative_to(ROOT).as_posix() for p in _port_sources()}
    assert len(TEXT_AND_AUDIO) == 30 and set(TEXT_AND_AUDIO) <= walked


def test_text_and_audio_without_device_raise_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tok = mt.functional.text.WordPieceTokenizer(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a"])
    for make in (mt.TranslationEditRate, mt.ExtendedEditDistance, mt.BLEUScore, mt.SacreBLEUScore, mt.CHRFScore,
                 mt.ROUGEScore, mt.SQuAD, lambda: mt.BERTScore(model=object(), user_tokenizer=tok),
                 mt.SignalNoiseRatio, mt.ScaleInvariantSignalNoiseRatio, mt.SignalDistortionRatio,
                 mt.ScaleInvariantSignalDistortionRatio,
                 lambda: mt.PermutationInvariantTraining(mt.functional.signal_noise_ratio)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert mt.BLEUScore(device="cpu").numerator.device == torch.device("cpu")
    assert mt.PermutationInvariantTraining(mt.functional.signal_noise_ratio, device="cpu").device == torch.device("cpu")


SERVE = tuple(
    f"metrics_tpu_torch/serve/{name}.py"
    for name in ("__init__", "registry", "ingest", "traffic", "httpd", "server", "wal", "columnar", "router", "autoscaler",
                 "coordinator", "fleet", "worker", "loadgen", "_loadgen_child", "soak")
)


def test_the_walk_covers_the_serve_modules():
    walked = {p.relative_to(ROOT).as_posix() for p in _port_sources()}
    jax_serve = {p.name for p in (ROOT / "metrics_tpu" / "serve").glob("*.py")}
    assert len(SERVE) == 16 and set(SERVE) <= walked
    assert {Path(p).name for p in SERVE} == jax_serve


def test_the_worker_process_and_the_loadgen_child_load_neither_jax_nor_metrics_tpu():
    """A worker started as ``python -m metrics_tpu_torch.serve.worker`` and a loadgen child run by path, as the
    fleet starts them: the worker reports its port, and neither process ever loads JAX or the JAX package."""
    probe = (
        "import runpy, sys, threading\n"
        "def check():\n"
        "    bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'metrics_tpu'))\n"
        "    print('BAD', bad, flush=True)\n"
        "{body}"
    )
    worker = probe.format(body=(
        "import signal, os\n"
        "timer = threading.Timer(60.0, lambda: os.kill(os.getpid(), signal.SIGTERM))\n"
        "timer.daemon = True\n"
        "timer.start()\n"
        "sys.argv = ['worker', '--shard', '0', '--num-shards', '1', '--device', 'cpu']\n"
        "try:\n"
        "    runpy.run_module('metrics_tpu_torch.serve.worker', run_name='__main__')\n"
        "finally:\n"
        "    check()\n"
    ))
    proc = subprocess.Popen([sys.executable, "-c", worker], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        ready = proc.stdout.readline().strip()
        assert ready.startswith("READY "), (ready, proc.stderr.read() if proc.poll() is not None else "")
        proc.terminate()
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert "BAD []" in out, (out, err)
    child = ROOT / "metrics_tpu_torch" / "serve" / "_loadgen_child.py"
    run = probe.format(body=(
        f"sys.argv = ['child', '--url', 'http://127.0.0.1:9', '--job', 'x', '--lo', '0', '--hi', '4',"
        f" '--timeout', '0.5']\n"
        f"runpy.run_path({str(child)!r}, run_name='__main__')\n"
        "check()\n"
    ))
    done = subprocess.run([sys.executable, "-c", run], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert done.returncode == 0 and "BAD []" in done.stdout, (done.stdout, done.stderr)
    assert '"sent": 4' in done.stdout and '"errors": 1' in done.stdout


def test_importing_a_fleet_worker_imports_no_optional_package():
    """A worker's start-up is a failover's cost: the port finds its optional packages without importing them."""
    code = (
        "import sys, metrics_tpu_torch.serve.worker\n"
        "from metrics_tpu_torch.utils import imports\n"
        "optional = {'transformers', 'sklearn', 'scipy', 'nltk', 'pesq', 'pystoi', 'sacrebleu', 'regex', 'PIL'}\n"
        "loaded = sorted(optional & {m.split('.')[0] for m in sys.modules})\n"
        "assert not loaded, loaded\n"
        "assert imports._TORCH_AVAILABLE and imports._SCIPY_AVAILABLE\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_a_fleet_worker_and_soak_without_device_raise_when_cuda_is_absent(monkeypatch):
    from metrics_tpu_torch.serve import FleetSpec, JobSpec
    from metrics_tpu_torch.serve import soak, worker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FleetSpec(num_shards=1, jobs=[JobSpec("mse", mt.MeanSquaredError)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        worker.run_worker(0, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        worker.drill_jobs(4)[0].build()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        soak.make_soak_registry(4)
    proc = subprocess.run([sys.executable, "-m", "metrics_tpu_torch.serve.worker", "--shard", "0", "--num-shards", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={**__import__("os").environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and "READY" not in proc.stdout and "CUDA is not available" in proc.stderr


def test_importing_the_serve_tier_loads_neither_jax_nor_metrics_tpu():
    code = (
        "import sys, metrics_tpu_torch.serve\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'metrics_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_a_serve_registry_without_device_raises_when_cuda_is_absent(monkeypatch):
    from metrics_tpu_torch.serve import EvalServer, MetricRegistry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reg = MetricRegistry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        reg.register("mse", mt.MeanSquaredError())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        reg.register("tenants", mt.MultiStreamMetric(mt.MeanSquaredError(device="cpu"), num_streams=4))
    assert len(reg) == 0
    reg.register("mse", mt.MeanSquaredError(device="cpu"))
    assert EvalServer(reg).registry.device == torch.device("cpu")


# names the JAX package's root exports that the port leaves out on purpose: none (the mesh tier is ported)
LEFT_OUT_ON_PURPOSE = set()


def test_the_root_all_covers_the_jax_root_all():
    import metrics_tpu

    assert set(metrics_tpu.__all__) - LEFT_OUT_ON_PURPOSE <= set(mt.__all__)
    star = {}
    exec("from metrics_tpu_torch import *", star)
    for name in ("functional", "checkpoint", "multistream"):
        assert star[name] is getattr(mt, name)


def test_the_serve_all_is_the_jax_one():
    import metrics_tpu.serve as jserve

    import metrics_tpu_torch.serve as tserve

    assert tserve.__all__ == jserve.__all__
    assert all(hasattr(tserve, name) for name in tserve.__all__)
    for name in tserve.__all__:
        ours, theirs = getattr(tserve, name), getattr(jserve, name)
        assert ours.__module__.replace("metrics_tpu_torch.", "metrics_tpu.") == theirs.__module__, name
