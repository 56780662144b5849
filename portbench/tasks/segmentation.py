"""Semantic-segmentation evaluation: a ``MetricCollection`` fed ``(N, C, H, W)`` float32 logits and
``(N, H, W)`` int64 labels batch by batch, each step's batch value read on the host, and ``compute()``
plus ``reset()`` at the end of each pass over the split.

The inputs are a pool of distinct batches made on the card from the seed and cycled through each pass:
step ``j`` of a pass takes pool batch ``j % pool_batches``; a short last batch takes the first images of
its pool batch.  Labels come in square blocks drawn from the configuration's class shares; each image's
prediction keeps the label on a share of its pixels drawn from ``top1_share`` and elsewhere is a uniform
class; the logits are uniform noise with the predicted class raised above the noise's maximum by a gap
drawn from ``top_gap``, so each pixel has one strict maximum.
"""

import time
from typing import Any, Dict, List, Tuple

import torch

from portbench.harness import Outcome, Stages
from portbench.reference import segmentation as ref


def make_batch(gen: torch.Generator, n: int, cfg: Dict[str, Any], device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    classes, h, w, block = cfg["num_classes"], cfg["height"], cfg["width"], cfg["label_block"]
    shares = torch.tensor(cfg["class_shares"], device=device)
    blocks = torch.multinomial(shares, n * (h // block) * (w // block), replacement=True, generator=gen)
    labels = blocks.view(n, h // block, w // block).repeat_interleave(block, 1).repeat_interleave(block, 2)
    lo, hi = cfg["top1_share"]
    keep_share = lo + (hi - lo) * torch.rand(n, 1, 1, generator=gen, device=device)
    keep = torch.rand(n, h, w, generator=gen, device=device) < keep_share
    other = torch.randint(0, classes, (n, h, w), generator=gen, device=device)
    pred = torch.where(keep, labels, other)
    del keep, other
    logits = torch.rand(n, classes, h, w, generator=gen, device=device) * cfg["logit_scale"]
    glo, ghi = cfg["top_gap"]
    top = logits.amax(1, keepdim=True) + glo + (ghi - glo) * torch.rand(n, 1, h, w, generator=gen, device=device)
    logits.scatter_(1, pred.unsqueeze(1), top)
    return logits, labels.contiguous()


def make_pool(seed: int, cfg: Dict[str, Any], traffic: Dict[str, Any], device: str):
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    pool = [make_batch(gen, traffic["batch"], cfg, device) for _ in range(traffic["pool_batches"])]
    return [p[0] for p in pool], [p[1] for p in pool]


def schedule(cfg: Dict[str, Any], traffic: Dict[str, Any]) -> List[Tuple[int, int]]:
    """(pool batch, images) of each step of a pass."""
    batch, total = traffic["batch"], cfg["images_per_pass"]
    return [(j % traffic["pool_batches"], min(batch, total - j * batch)) for j in range(-(-total // batch))]


def build(cfg: Dict[str, Any], device: str):
    import metrics_tpu_torch as mt

    members = [getattr(mt, m["class"])(**m["kwargs"], device=device) for m in cfg["metrics"]]
    return mt.MetricCollection(members, device=device)


def states(collection) -> Dict[str, Dict[str, torch.Tensor]]:
    return {name: {k: getattr(m, k).clone() for k in m._defaults} for name, m in collection.items()}


def sync(device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def run(cell, seed: int, seconds: float, tracer, device: str, t0: float, limits: Dict[str, float]) -> Outcome:
    cfg, traffic = cell.config, cell.traffic
    stages = Stages(t0)
    stages.mark("imports")
    logits, labels = make_pool(seed, cfg, traffic, device)
    sync(device)
    stages.mark("inputs")
    pool_bytes = torch.cuda.memory_allocated() if device.startswith("cuda") else 0
    collection = build(cfg, device)
    stages.mark("metric")
    plan = schedule(cfg, traffic)
    read_key, call = traffic["read_each_step"], traffic["call"]

    def inputs(p: int, n: int):
        return (logits[p], labels[p]) if n == traffic["batch"] else (logits[p][:n], labels[p][:n])

    def step(p: int, n: int):
        if call == "forward":
            out = collection(*inputs(p, n))
            float(out[read_key])  # the step's score, read on the host as a progress log reads it
            return out
        collection.update(*inputs(p, n))
        return None

    # warm every shape of the pass: the full batch, the short last one, the pass end
    for p, n in sorted({(0, n) for _, n in plan}):
        step(p, n)
    collection.compute()
    collection.reset()
    sync(device)
    stages.mark("warm-up")
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated() if device.startswith("cuda") else 0
    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()

    steps: List[Tuple[int, int, int, Any]] = []  # (pass, step of the pass, images, batch values)
    passes: List[Tuple[Dict[str, Any], Dict[str, Dict[str, torch.Tensor]]]] = []  # (compute(), states before reset)
    pixels = 0
    tracer.start()
    start = time.perf_counter()
    with tracer.span("pb.window"):
        j = 0
        while True:
            p, n = plan[j]
            with tracer.span("pb.step"):
                out = step(p, n)
            steps.append((len(passes), j, n, out))
            pixels += n * cfg["height"] * cfg["width"]
            j += 1
            if j == len(plan):
                with tracer.span("pb.compute"):
                    res = collection.compute()
                    float(res[read_key])  # the pass's score, read on the host
                    snap = states(collection)
                    collection.reset()
                passes.append((res, snap))
                j = 0
            if time.perf_counter() - start >= seconds:
                break
        sync(device)
    window_s = time.perf_counter() - start
    tracer.stop()
    window_peak = torch.cuda.max_memory_allocated() if device.startswith("cuda") else 0
    partial = states(collection)
    del collection
    checks, attempted, failed = judge(cfg, traffic, plan, logits, labels, steps, passes, partial, limits)
    images = sum(s[2] for s in steps)
    return Outcome(
        setup_s=setup_s,
        end_to_end={"mpixels_per_s": pixels / window_s / 1e6,
                    "metric_peak_mib": (window_peak - pool_bytes) / 2**20},
        counts={"images": images, "height": cfg["height"], "width": cfg["width"], "num_classes": cfg["num_classes"]},
        memory_peak_bytes=max(setup_peak, window_peak),
        checks=checks,
        attempted=attempted,
        failed=failed,
        setup_stages=stages.seconds,
    )


def _rel(value: float, want: float) -> float:
    return abs(value - want) / max(abs(want), 1e-30)


def _count_diff(got: torch.Tensor, want: torch.Tensor) -> int:
    """Sum of absolute differences of integer counts, exact: the reference's are int64."""
    return int((got.to(torch.int64).cpu() - want.to(torch.int64).cpu()).abs().sum())


def _average(cfg: Dict[str, Any], name: str) -> str:
    member = next(m for m in cfg["metrics"] if m["class"] == name)
    return member["kwargs"].get("average", "micro")


def judge(cfg, traffic, plan, logits, labels, steps, passes, partial, limits):
    """Every answer of the window against the reference: each step's batch values, each pass's states and
    ``compute()``, and the states of the unfinished pass.  Returns the numbers compared (each the worst
    over the window), the answers compared and the answers outside a limit."""
    classes = cfg["num_classes"]
    average = _average(cfg, "Accuracy")
    confs: Dict[Tuple[int, int], torch.Tensor] = {}
    for p, n in sorted(set(plan)):
        confs[(p, n)] = ref.confusion(logits[p][:n], labels[p][:n], classes).cpu()
    prefix = [torch.zeros(classes, classes, dtype=torch.int64)]
    for key in plan:
        prefix.append(prefix[-1] + confs[key])
    worst = {"count_diff": 0.0, "miou_err": 0.0, "acc_err": 0.0}
    failed = 0

    def score(values: Dict[str, Any], want_cm: torch.Tensor) -> Dict[str, float]:
        got = {"count_diff": 0.0, "miou_err": 0.0, "acc_err": 0.0}
        for m in cfg["metrics"]:
            name, value = m["class"], values[m["class"]]
            if name == "ConfusionMatrix":
                got["count_diff"] += _count_diff(value, want_cm)
            elif name == "JaccardIndex":
                got["miou_err"] = max(got["miou_err"], _rel(float(value), ref.jaccard(want_cm)))
            elif name == "Accuracy":
                got["acc_err"] = max(got["acc_err"], _rel(float(value), ref.accuracy(want_cm, average)))
        return got

    def state_diff(snap: Dict[str, Dict[str, torch.Tensor]], want_cm: torch.Tensor) -> float:
        counts = ref.stat_counts(want_cm, average)
        diff = 0
        for name, st in snap.items():
            for key, value in st.items():
                if key == "confmat":
                    diff += _count_diff(value, want_cm)
                elif key in counts:
                    diff += _count_diff(value, counts[key])
        return float(diff)

    def fold(got: Dict[str, float]) -> None:
        nonlocal failed
        bad = False
        for k, v in got.items():
            worst[k] = max(worst[k], v) if v == v else float("nan")
            bad |= not (v <= limits.get(k, -1.0))
        failed += bad

    for _, j, n, out in steps:
        if out is not None:
            fold(score(out, confs[plan[j]]))
    for res, snap in passes:
        got = score(res, prefix[-1])
        got["count_diff"] += state_diff(snap, prefix[-1])
        fold(got)
    done = (steps[-1][1] + 1) % len(plan) if steps else 0
    if done:
        fold({"count_diff": state_diff(partial, prefix[done]), "miou_err": 0.0, "acc_err": 0.0})
    attempted = sum(out is not None for *_, out in steps) + len(passes) + (1 if done else 0)
    return sorted(worst.items()), attempted, failed


def control(cell, seed: int, device: str, limits: Dict[str, float]):
    """The numbers compared, with the reference one step below the stated precision (bfloat16 logits) in
    the program's place over one whole pass of the run's own inputs."""
    cfg, traffic = cell.config, cell.traffic
    logits, labels = make_pool(seed, cfg, traffic, device)
    plan = schedule(cfg, traffic)
    low = {(p, n): ref.confusion(logits[p][:n].to(torch.bfloat16), labels[p][:n], cfg["num_classes"]).cpu()
           for p, n in set(plan)}

    average = _average(cfg, "Accuracy")

    def answers(cm: torch.Tensor) -> Dict[str, Any]:
        return {"JaccardIndex": ref.jaccard(cm), "Accuracy": ref.accuracy(cm, average), "ConfusionMatrix": cm}

    steps = [(0, j, n, answers(low[(p, n)])) for j, (p, n) in enumerate(plan)]
    total = sum(low[key] for key in plan)
    counts = ref.stat_counts(total, average)
    snap = {m["class"]: ({"confmat": total} if m["class"] != "Accuracy" else counts) for m in cfg["metrics"]}
    return judge(cfg, traffic, plan, logits, labels, steps, [(answers(total), snap)], None, limits)
