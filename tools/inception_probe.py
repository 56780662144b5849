"""Time the port's Inception-v3 extractor on one NVIDIA GPU in several layouts, and FID's eigh precision.

Run from the root of a checkout:

    python3 tools/inception_probe.py

For float32 (TF32 off) at batches of 100 and 500 and for bfloat16 at 500, it
times one extractor call per image (CUDA events, the median of five after a
warm-up) with the model and the input in NCHW and in channels-last memory
format, with ``torch.backends.cudnn.benchmark`` off and on, each variant's
features against the NCHW float32 ones.  Then it measures the float32
``torch.linalg.eigvalsh`` of a 2048 x 2048 covariance of Inception features
on the card and on the CPU against float64, and prints one JSON line.
"""

import json
import statistics
import sys
import warnings
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from metrics_tpu_torch.image.backbones import InceptionFeatureExtractor  # noqa: E402
from metrics_tpu_torch.image.fid import _compute_fid  # noqa: E402

DEVICE = "cuda"


def _images(n: int, seed: int = 0) -> torch.Tensor:
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return torch.randint(0, 256, (n, 3, 32, 32), generator=gen, device=DEVICE, dtype=torch.uint8)


def _ms_per_image(fn, imgs: torch.Tensor, reps: int = 5) -> float:
    fn(imgs)
    fn(imgs)
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(imgs)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times) / imgs.shape[0]


def _variant(extractor: InceptionFeatureExtractor, channels_last: bool):
    net = extractor.network()
    if channels_last:
        net.to(memory_format=torch.channels_last)

    def run(imgs):
        x = extractor.preprocess(imgs)
        if extractor.compute_dtype is not None:
            x = x.to(extractor.compute_dtype)
        if channels_last:
            x = x.contiguous(memory_format=torch.channels_last)
        cudnn = torch.backends.cudnn
        with torch.no_grad(), cudnn.flags(enabled=True, benchmark=cudnn.benchmark, deterministic=False,
                                          allow_tf32=False):
            return net(x, extractor.feature)[extractor.feature].float()

    return run


def main() -> int:
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda, torch.backends.cudnn.version())
    warnings.simplefilter("ignore", UserWarning)
    out = {"timings": {}}
    ref_imgs = _images(500)
    base = InceptionFeatureExtractor("2048", device=DEVICE)
    want = base(ref_imgs)
    for dtype in (None, torch.bfloat16):
        for optimized in ((False, True) if dtype is not None else (False,)):
            for channels_last in (False, True):
                for bench in (False, True):
                    torch.backends.cudnn.benchmark = bench
                    extractor = InceptionFeatureExtractor("2048", compute_dtype=dtype, optimized=optimized,
                                                          device=DEVICE)
                    run = _variant(extractor, channels_last)
                    err = float((run(ref_imgs) - want).abs().max())
                    for size in ((100, 500) if dtype is None else (500,)):
                        name = (f"{'bf16' if dtype else 'float32'}{'_folded' if optimized else ''}_"
                                f"{'channels_last' if channels_last else 'nchw'}_{'bench' if bench else 'heur'}_{size}")
                        ms = _ms_per_image(run, _images(size, 1))
                        out["timings"][name] = {"ms_per_image": ms, "max_abs_err_vs_nchw_f32": err}
                        print(f"{name}: {ms!r} ms an image, features within {err!r} of NCHW float32")
    torch.backends.cudnn.benchmark = False
    # FID's eigh: a covariance of 10,000 feature rows, float32 on the card and the CPU against float64
    feats = torch.cat([base(_images(500, 10 + i)) for i in range(20)]).double()
    cov = torch.cov(feats.T)
    exact = torch.linalg.eigvalsh(cov.cpu())
    for where in ("cuda", "cpu"):
        got = torch.linalg.eigvalsh(cov.to(where, torch.float32)).double().cpu()
        out[f"eigvalsh_{where}_max_abs_err"] = float((got - exact).abs().max())
        out[f"eigvalsh_{where}_sqrt_sum_err"] = float(got.clamp(min=0).sqrt().sum() - exact.clamp(min=0).sqrt().sum())
    mu = feats.mean(0)
    fake = feats[:, torch.randperm(2048, generator=torch.Generator().manual_seed(0)).cuda()]
    cov2, mu2 = torch.cov(fake.T), fake.mean(0)
    out["fid"] = {where + "_" + str(dtype).split(".")[-1]: float(_compute_fid(
        mu.to(where, dtype), cov.to(where, dtype), mu2.to(where, dtype), cov2.to(where, dtype)))
        for where in ("cuda", "cpu") for dtype in (torch.float32, torch.float64)}
    out["largest_eigenvalue"] = float(exact[-1])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
