"""Frechet Inception Distance over a generative model's evaluation: passes of real and generated inputs
through ``FrechetInceptionDistance.update`` in caller batches, then ``compute()`` (its value read on the
host) and ``reset()``, back to back.

The inputs are made on the card from the seed: uint8 images as a generator's evaluation feeds them (the
real set uniform noise, the generated set a blurred and shifted copy of another draw), or, for callers
that bring their own features, non-negative 2048-wide rows ``|z M|`` with a full-rank covariance.  The
Inception-v3 weights are seeded random (He-normal convolutions, batch norms near the identity), made in
one draw on the card and handed to the port as the JAX package's variables tree and to the reference as
plain tensors.
"""

import random
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench.harness import Outcome, Stages
from portbench.reference import fid as ref_fid
from portbench.reference.inception import FC_SHAPE, UNITS, PlainInception

SIDES = (True, False)  # real, then generated


def weight_layout() -> List[Tuple[str, Tuple[int, ...], float, float]]:
    """(name, shape, scale, shift) of every weight: the draw is ``normal * scale + shift``."""
    out = []
    for name, cin, cout, k, _, _ in UNITS:
        out.append((f"{name}.conv.weight", (cout, cin, k[0], k[1]), (2.0 / (cin * k[0] * k[1])) ** 0.5, 0.0))
        out.append((f"{name}.bn.weight", (cout,), 0.1, 1.0))
        out.append((f"{name}.bn.bias", (cout,), 0.1, 0.0))
        out.append((f"{name}.bn.running_mean", (cout,), 0.1, 0.0))
        out.append((f"{name}.bn.running_var", (cout,), 0.1, 1.0))
    out.append(("fc.weight", FC_SHAPE, (1.0 / FC_SHAPE[1]) ** 0.5, 0.0))
    return out


def make_weights(gen: torch.Generator, device: str) -> torch.Tensor:
    """Every weight in one flat float32 tensor, in :func:`weight_layout`'s order: one draw, one affine."""
    layout = weight_layout()
    sizes = torch.tensor([int(np.prod(s)) for _, s, _, _ in layout], device=device)
    scale = torch.tensor([c for _, _, c, _ in layout], device=device).repeat_interleave(sizes)
    shift = torch.tensor([b for _, _, _, b in layout], device=device).repeat_interleave(sizes)
    return torch.randn(int(sizes.sum()), generator=gen, device=device) * scale + shift


def unflatten(flat) -> Dict[str, Any]:
    """Views of ``flat`` (a tensor or a numpy array) under each weight's name and shape."""
    out, at = {}, 0
    for name, shape, _, _ in weight_layout():
        n = int(np.prod(shape))
        out[name] = flat[at : at + n].reshape(shape)
        at += n
    return out


def variables_tree(flat: np.ndarray) -> Dict[str, Any]:
    """The JAX package's Inception variables (``params`` / ``batch_stats``, HWIO kernels), numpy on the host,
    with the units numbered in definition order."""
    w = unflatten(flat)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for i, (name, *_rest) in enumerate(UNITS):
        params[f"ConvBN_{i}"] = {"Conv_0": {"kernel": w[f"{name}.conv.weight"].transpose(2, 3, 1, 0)},
                                 "BatchNorm_0": {"scale": w[f"{name}.bn.weight"], "bias": w[f"{name}.bn.bias"]}}
        stats[f"ConvBN_{i}"] = {"BatchNorm_0": {"mean": w[f"{name}.bn.running_mean"],
                                                "var": w[f"{name}.bn.running_var"]}}
    params["Dense_0"] = {"kernel": w["fc.weight"].T}
    return {"params": params, "batch_stats": stats}


def make_inputs(gen: torch.Generator, cfg: Dict[str, Any], traffic: Dict[str, Any], device: str):
    """The real and the generated inputs of one pass."""
    if traffic["input"] == "images":
        shape = (cfg["channels"], cfg["image_side"], cfg["image_side"])
        real = torch.randint(0, 256, (traffic["real_per_pass"], *shape), generator=gen, device=device,
                             dtype=torch.int32).to(torch.uint8)
        base = torch.randint(0, 256, (traffic["fake_per_pass"], *shape), generator=gen, device=device,
                             dtype=torch.int32)
        noise = torch.randint(-24, 25, base.shape, generator=gen, device=device, dtype=torch.int32)
        fake = (base * 7 // 8 + 16 + noise).clamp(0, 255).to(torch.uint8)
        return real, fake
    dim = cfg["feature"]
    mix = torch.randn(dim, dim, generator=gen, device=device) / dim**0.5
    mix_fake = 0.9 * mix + 0.3 * torch.randn(dim, dim, generator=gen, device=device) / dim**0.5
    real = (torch.randn(traffic["real_per_pass"], dim, generator=gen, device=device) @ mix).abs()
    fake = (torch.randn(traffic["fake_per_pass"], dim, generator=gen, device=device) @ mix_fake).abs()
    return real, fake


class Tap:
    """The metric's extractor behind a span, keeping the features of the sampled batches."""

    def __init__(self, inner, tracer, sampled) -> None:
        self.inner, self.tracer, self.sampled = inner, tracer, sampled
        self.current: Optional[Tuple[int, bool, int]] = None
        self.kept: Dict[Tuple[int, bool, int], torch.Tensor] = {}

    def __call__(self, x):
        with self.tracer.span("pb.extractor"):
            out = self.inner(x)
        if self.current is not None and self.current[1:] in self.sampled:
            self.kept[self.current] = out.detach().clone()
        return out


STATE_KEYS = ("real_sum", "real_outer", "real_n", "fake_sum", "fake_outer", "fake_n")


def snapshot(metric) -> Dict[str, torch.Tensor]:
    return {k: getattr(metric, k).clone() for k in STATE_KEYS}


def sync(device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def identity(x):
    return x


def prepare(seed: int, cfg: Dict[str, Any], traffic: Dict[str, Any], device: str):
    """The run's weights (host numpy, images only), inputs, sampled batches and order of a pass, all from
    the seed."""
    batch = traffic["batch"]
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    images = traffic["input"] == "images"
    flat_host = make_weights(gen, device).cpu().numpy() if images else None
    real, fake = make_inputs(gen, cfg, traffic, device)
    pick = random.Random(seed)
    n_batches = {True: traffic["real_per_pass"] // batch, False: traffic["fake_per_pass"] // batch}
    sampled = {(side, pick.randrange(n_batches[side])) for side in SIDES} if images else set()
    order = [(side, i) for side in SIDES for i in range(n_batches[side])]
    return flat_host, real, fake, sampled, order


def plain_net(flat_host, device: str):
    if flat_host is None:
        return identity
    return PlainInception({k: torch.as_tensor(v, device=device) for k, v in unflatten(flat_host).items()})


def run(cell, seed: int, seconds: float, tracer, device: str, t0: float, limits: Dict[str, float]) -> Outcome:
    import metrics_tpu_torch as mt

    cfg, traffic = cell.config, cell.traffic
    batch = traffic["batch"]
    stages = Stages(t0)
    stages.mark("imports")
    flat_host, real, fake, sampled, order = prepare(seed, cfg, traffic, device)
    images = flat_host is not None
    sync(device)
    stages.mark("inputs")
    pool_bytes = torch.cuda.memory_allocated() if device.startswith("cuda") else 0
    if images:
        metric = mt.FrechetInceptionDistance(feature=cfg["feature"], inception_params=variables_tree(flat_host),
                                             reset_real_features=traffic["reset_real_features"], device=device)
    else:
        metric = mt.FrechetInceptionDistance(feature=identity, feature_dim=cfg["feature"],
                                             reset_real_features=traffic["reset_real_features"], device=device)
    tap = Tap(metric.extractor, tracer, sampled)
    metric.extractor = tap
    stages.mark("metric")

    def rows(side: bool, i: int) -> torch.Tensor:
        return (real if side else fake)[i * batch : (i + 1) * batch]

    # warm the pass's shapes: an update of each side, the pass end
    for side in SIDES:
        metric.update(rows(side, 0), real=side)
    float(metric.compute())
    metric.reset()
    sync(device)
    stages.mark("warm-up")
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated() if device.startswith("cuda") else 0
    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()

    values: List[float] = []
    first_pass: Optional[Dict[str, torch.Tensor]] = None
    folded = 0
    k = 0
    tracer.start()
    start = time.perf_counter()
    with tracer.span("pb.window"):
        while True:
            side, i = order[k]
            tap.current = (len(values), side, i)
            with tracer.span("pb.update"):
                metric.update(rows(side, i), real=side)
            folded += batch
            k += 1
            if k == len(order):
                with tracer.span("pb.compute"):
                    if first_pass is None:
                        first_pass = snapshot(metric)
                    values.append(float(metric.compute()))
                    metric.reset()
                k = 0
            if time.perf_counter() - start >= seconds:
                break
        sync(device)
    window_s = time.perf_counter() - start
    tracer.stop()
    window_peak = torch.cuda.max_memory_allocated() if device.startswith("cuda") else 0
    partial = snapshot(metric) if k else None
    kept = tap.kept
    del metric, tap
    answers = {"values": values, "first_pass": first_pass, "partial": (k, partial), "features": kept}
    want = reference(plain_net(flat_host, device), real, fake, order, batch, k, sampled)
    checks, attempted, failed = judge(answers, want, limits, images)
    return Outcome(
        setup_s=setup_s,
        end_to_end={"images_per_s": folded / window_s, "metric_peak_mib": (window_peak - pool_bytes) / 2**20},
        counts={"rows": folded, "input_images": int(images)},
        memory_peak_bytes=max(setup_peak, window_peak),
        checks=checks,
        attempted=attempted,
        failed=failed,
        setup_stages=stages.seconds,
    )


def reference(net, real, fake, order, batch, cut, sampled, tf32: bool = False):
    """The reference's states over a whole pass and over the first ``cut`` batches of one (float64),
    its features of the sampled batches, and its FID of the whole pass.  ``tf32`` computes it one step
    below the configuration's precision, the control: TF32 convolutions and products, float32 states."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False, allow_tf32=tf32):
        matmul = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            return _reference(net, real, fake, order, batch, cut, sampled, torch.float32 if tf32 else torch.float64)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul


def _reference(net, real, fake, order, batch, cut, sampled, dtype):
    acc = {side: ref_fid.Moments(dtype) for side in SIDES}
    partial = None
    feats = {}
    for k, (side, i) in enumerate(order):
        if k == cut and cut:
            partial = {s: acc[s].copy() for s in SIDES}
        x = (real if side else fake)[i * batch : (i + 1) * batch]
        f = net(x)
        if (side, i) in sampled:
            feats[(side, i)] = f.clone()
        acc[side].add(f)
    return {"full": acc, "partial": partial, "features": feats,
            "fid": ref_fid.frechet_distance(acc[True], acc[False])}


def _rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest absolute difference over the largest magnitude of the reference; an answer of another shape
    is wrong by any measure."""
    if got.shape != want.shape:
        return float("inf")
    want = want.to(torch.float64)
    return float((got.to(torch.float64) - want).abs().max() / want.abs().max().clamp(min=1e-300))


def judge(answers, want, limits, images: bool):
    """Each pass's FID, the states of the first whole pass and of the unfinished one, and the features of
    the sampled batches, against the reference."""
    worst = {"count_diff": 0.0, "state_err": 0.0}
    if images:
        worst["feat_err"] = 0.0
    # a pass's value is compared where a limit separates the program from the control (see PERF.md)
    compare_fid = "fid_err" in limits
    if compare_fid:
        worst["fid_err"] = 0.0
    failed = attempted = 0

    def fold(got: Dict[str, float]) -> None:
        nonlocal failed, attempted
        attempted += 1
        bad = False
        for key, v in got.items():
            worst[key] = max(worst[key], v) if v == v else float("nan")
            bad |= not (v <= limits.get(key, -1.0))
        failed += bad

    def states(snap, moments) -> Dict[str, float]:
        got = {"count_diff": 0.0, "state_err": 0.0}
        for side, name in ((True, "real"), (False, "fake")):
            m = moments[side]
            got["count_diff"] += abs(float(snap[f"{name}_n"]) - m.n)
            if m.n:
                got["state_err"] = max(got["state_err"], _rel_max(snap[f"{name}_sum"], m.total),
                                       _rel_max(snap[f"{name}_outer"], m.outer))
        return got

    for value in answers["values"] if compare_fid else ():
        fold({"fid_err": abs(value - want["fid"]) / abs(want["fid"])})
    if answers["first_pass"] is not None:
        fold(states(answers["first_pass"], want["full"]))
    cut, partial = answers["partial"]
    if partial is not None:
        fold(states(partial, want["partial"]))
    for (_, side, i), f in answers["features"].items():
        fold({"feat_err": _rel_max(f, want["features"][(side, i)])})
    return sorted(worst.items()), attempted, failed


def control(cell, seed: int, device: str, limits: Dict[str, float]):
    """The numbers compared, with the reference one step below the stated precision (TF32) in the
    program's place over one whole pass of the run's own inputs."""
    cfg, traffic = cell.config, cell.traffic
    flat_host, real, fake, sampled, order = prepare(seed, cfg, traffic, device)
    net = plain_net(flat_host, device)
    want = reference(net, real, fake, order, traffic["batch"], 0, sampled)
    low = reference(net, real, fake, order, traffic["batch"], 0, sampled, tf32=True)
    state = {}
    for side, name in ((True, "real"), (False, "fake")):
        m = low["full"][side]
        state.update({f"{name}_sum": m.total, f"{name}_outer": m.outer, f"{name}_n": torch.tensor(float(m.n))})
    answers = {"values": [low["fid"]], "first_pass": state, "partial": (0, None),
               "features": {(0, side, i): f for (side, i), f in low["features"].items()}}
    return judge(answers, want, limits, flat_host is not None)
