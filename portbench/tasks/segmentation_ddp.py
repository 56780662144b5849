"""Data-parallel semantic-segmentation evaluation: ``world_size`` ranks, one a card, each feeding its own share
of the split to the configuration's ``MetricCollection`` through the port's normal path.

Every member is built with ``dist_sync_on_step=True``, so each ``forward`` syncs the batch state over the
default process group (the port's ``DistBackend``: preflight digests, one packed gather, the rank-order
reduce) and returns the value of every rank's batch together, which each rank reads on the host; at each
pass end a synced ``compute()``, its score read on the host, then ``reset()``.  The ranks run in lockstep
through those syncs.  A pass is ``images_per_pass`` images, an equal share a rank; rank ``r``'s pool of
distinct batches is :func:`portbench.tasks.segmentation.make_pool` of ``seed * world_size + r``, made on
its card and cycled through each pass as in the one-card cell.  The window ends at a pass end, agreed
through one plain all-reduce of a stop flag outside ``pb.step``, so it holds whole passes.

Rank 0 is the harness's own process; ranks 1 and up are spawned processes, each on its own share of the
host's cores with one intra-op thread, as a launcher of one process a card runs them (``torchrun`` sets
``OMP_NUM_THREADS=1``).  Nothing waits without a limit:
the process group has a finite timeout, and a watcher in rank 0 kills every rank and exits the process
non-zero, printing no result, as soon as a rank exits non-zero or the run outlives its deadline.

What is judged after the window, against :mod:`portbench.reference.segmentation_ddp` (each rank's int64
reference confusions, combined with plain ``torch.distributed`` calls): on rank 0, every step's three batch
values against the sum over the ranks of that step's confusions, and every pass's ``compute()`` against
the sum over its images; on every rank, each pass's states and the unfinished state against its own
images; and ``rank_diff``, the answers of each rank that differ in a bit from rank 0's.
"""

import datetime
import multiprocessing
import multiprocessing.connection
import os
import resource
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from portbench import faults as shared_faults
from portbench import port_spans
from portbench.harness import Outcome, Stages
from portbench.reference import segmentation as ref
from portbench.reference import segmentation_ddp as ref_ddp
from portbench.run import forbidden_modules
from portbench.tasks import segmentation as seg
from portbench.tracing import Tracer

HOST = "127.0.0.1"
GROUP_TIMEOUT_S = 120.0  # a collective that waits longer raises: no rank waits on a dead peer forever
SETUP_LIMIT_S = 600.0  # spawn, imports, pools, the first kernel builds and the warm-up, on every rank
END_LIMIT_S = 300.0  # the last pass past the window, the references, the judging and the teardown

# the fault planted on every rank of the next run (set through a patcher by the functions of FAULTS below)
FAULT: Optional[str] = None

# the numbers compared, in the order ranks send them; rank_diff last
CHECKS = ("count_diff", "miou_err", "acc_err", "rank_diff")


# ------------------------------------------------------------------ the shares of a pass


def schedule(cfg: Dict[str, Any], traffic: Dict[str, Any]) -> List[Tuple[int, int]]:
    """(pool batch, images) of each step of a rank's share of a pass, the same on every rank."""
    world = cfg["world_size"]
    if cfg["images_per_pass"] % world:
        raise ValueError(f"{cfg['images_per_pass']} images a pass do not split over {world} ranks")
    return seg.schedule({**cfg, "images_per_pass": cfg["images_per_pass"] // world}, traffic)


def rank_seed(seed: int, rank: int, world: int) -> int:
    return seed * world + rank


# ------------------------------------------------------------------ faults planted on every rank


def _plant(name: str, patch, rank: int, world: int) -> None:
    """Plant fault ``name`` in this rank's process; ``patch.undo()`` takes it out."""
    from metrics_tpu_torch.metric import Metric
    from metrics_tpu_torch.parallel.backend import DistBackend

    if name == "rank_off":  # the last rank's mIoU one float32 step up: only rank_diff can see it
        if rank == world - 1:
            from metrics_tpu_torch.classification import jaccard as jaccard_module

            original = jaccard_module._jaccard_from_confmat
            patch.setattr(jaccard_module, "_jaccard_from_confmat",
                          lambda *a, **k: torch.nextafter(original(*a, **k), torch.tensor(float("inf"))))
        return
    if name == "rank_dies":  # the last rank's process ends in its second step of the window
        steps = {"n": 0}

        def forward(self, *args, _o=Metric.forward, **kwargs):
            steps["n"] += 1
            if rank == world - 1 and steps["n"] == 3 * 3:  # three members a step: past the warm-up's steps
                os._exit(3)
            return _o(self, *args, **kwargs)

        patch.setattr(Metric, "forward", forward)
        return
    in_step = {"now": False}  # inside a forward's batch value, whose sync is the step's
    original_batch_value = Metric._batch_value

    def batch_value(self, *args, **kwargs):
        in_step["now"] = True
        try:
            return original_batch_value(self, *args, **kwargs)
        finally:
            in_step["now"] = False

    original_gather = DistBackend.all_gather_bytes

    def gather(self, payload):
        shards = original_gather(self, payload)
        if name == "rank_left_out" and in_step["now"]:
            return shards[:-1]  # the last rank's batch left out of each step's synced value
        if name == "rank_twice" and not in_step["now"]:
            return shards + [shards[1]]  # rank 1's pass state counted twice at each pass end
        return shards

    patch.setattr(Metric, "_batch_value", batch_value)
    patch.setattr(DistBackend, "all_gather_bytes", gather)


def _fault(name: str):
    def plant(patch) -> None:
        patch.setattr(sys.modules[__name__], "FAULT", name)

    plant.__name__ = name
    return plant


# the sync faults a run of this kind has to come out not correct with, beside the one-card kinds'
FAULTS = {"rank_left_out": _fault("rank_left_out"), "rank_twice": _fault("rank_twice")}
shared_faults.FAULTS.setdefault(("segmentation_ddp", "logits"), FAULTS)


# ------------------------------------------------------------------ the ranks


class _Watcher:
    """Rank 0's watch over the spawned ranks: once a rank exits non-zero, or the run outlives its deadline,
    every rank is killed and this process exits non-zero (a rank blocked in a collective cannot be woken)."""

    def __init__(self, procs: Sequence[multiprocessing.Process], deadline: float) -> None:
        self.procs, self.deadline = list(procs), deadline
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._watch, daemon=True, name="portbench-ranks")
        self.thread.start()

    def _watch(self) -> None:
        while not self.done.is_set():
            alive = [p.sentinel for p in self.procs if p.exitcode is None]
            if alive:
                multiprocessing.connection.wait(alive, timeout=0.5)
            else:
                self.done.wait(0.5)
            if self.done.is_set():
                return
            for rank, p in enumerate(self.procs, start=1):
                if p.exitcode not in (None, 0):
                    self.fail(f"rank {rank} exited with {p.exitcode}")
            if time.monotonic() > self.deadline:
                self.fail("the run outlived its deadline")

    def kill(self) -> None:
        for p in self.procs:
            if p.exitcode is None:
                p.kill()

    def fail(self, why: str) -> None:
        print(f"portbench: {why}; every rank killed, no result", file=sys.stderr, flush=True)
        self.kill()
        os._exit(1)

    def stop(self) -> None:
        self.done.set()
        self.thread.join()  # one thread at a time reaps the ranks

    def ended(self, wait: float) -> str:
        """The spawned ranks that exited non-zero within ``wait`` seconds (a peer's death is often why a
        collective of rank 0 raised)."""
        multiprocessing.connection.wait([p.sentinel for p in self.procs], timeout=wait)
        return "".join(f"; rank {rank} exited with {p.exitcode}" for rank, p in enumerate(self.procs, start=1)
                       if p.exitcode not in (None, 0))

    def join(self, timeout: float) -> None:
        """Wait for every spawned rank to exit 0 within ``timeout`` seconds, else fail."""
        self.stop()
        end = time.monotonic() + timeout
        for rank, p in enumerate(self.procs, start=1):
            p.join(max(end - time.monotonic(), 0.0))
            if p.exitcode != 0:
                self.fail(f"rank {rank} ended with {p.exitcode}")


def _shares(world: int) -> List[List[int]]:
    """Each rank's block of this process's cores (every core to each rank where there are fewer than ranks)."""
    cores = sorted(os.sched_getaffinity(0))
    share = len(cores) // world
    return [cores[r * share:(r + 1) * share] if share else cores for r in range(world)]


def _settle(cores: Sequence[int]) -> None:
    """Run this process's thread, and the threads it starts, on ``cores``, with one intra-op thread."""
    os.sched_setaffinity(0, cores)
    torch.set_num_threads(1)


def _usage() -> Tuple[float, float]:
    """(involuntary context switches, CPU seconds) of this process so far."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return float(ru.ru_nivcsw), ru.ru_utime + ru.ru_stime


def _watch_parent() -> None:
    """In a spawned rank: end this process once rank 0's has gone."""
    parent = multiprocessing.parent_process()

    def watch() -> None:
        multiprocessing.connection.wait([parent.sentinel])
        os._exit(1)

    threading.Thread(target=watch, daemon=True, name="portbench-parent").start()


def _spawned(rank: int, port: int, spec: Dict[str, Any]) -> None:
    """The body of a spawned rank: join the group, run the rank, leave with the exit code as the verdict."""
    try:
        _watch_parent()
        _settle(spec["cores"][rank])
        device, cfg = spec["device"], spec["config"]
        if device.startswith("cuda"):
            torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        store = dist.TCPStore(HOST, port, cfg["world_size"], False,
                              timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        _run_rank(rank, store, spec, Tracer(False), time.perf_counter(), None)
    except BaseException:  # noqa: BLE001 — the rank's verdict is its exit code, the traceback its message
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    sys.stdout.flush()
    os._exit(0)


def run(cell, seed: int, seconds: float, tracer, device: str, t0: float, limits: Dict[str, float]) -> Outcome:
    cfg = cell.config
    world = cfg["world_size"]
    stages = Stages(t0)
    stages.mark("imports")
    store = dist.TCPStore(HOST, 0, world, True, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
                          wait_for_workers=False)
    spec = {"config": cfg, "traffic": cell.traffic, "seed": seed, "seconds": seconds, "device": device,
            "limits": limits, "fault": FAULT, "cores": _shares(world)}
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_spawned, args=(rank, store.port, spec), daemon=True, name=f"portbench-rank{rank}")
             for rank in range(1, world)]
    for p in procs:
        p.start()
    watcher = _Watcher(procs, time.monotonic() + SETUP_LIMIT_S + seconds + END_LIMIT_S)
    stages.mark("spawn")
    saved = os.sched_getaffinity(0), torch.get_num_threads()
    _settle(spec["cores"][0])
    try:
        out = _run_rank(0, store, spec, tracer, t0, stages)
        watcher.join(END_LIMIT_S)
    except BaseException:  # noqa: BLE001 — the other ranks may be blocked in a collective: end them all
        traceback.print_exc()
        watcher.stop()
        watcher.fail("rank 0 raised" + watcher.ended(2.0))
    finally:
        os.sched_setaffinity(0, saved[0])
        torch.set_num_threads(saved[1])
    return out


def _run_rank(rank: int, store, spec: Dict[str, Any], tracer, t0: float, stages: Optional[Stages]):
    """One rank's run, from its pool to its verdict; rank 0 returns the :class:`Outcome`."""
    from metrics_tpu_torch import obs

    cfg, traffic, device = spec["config"], spec["traffic"], spec["device"]
    world, seconds = cfg["world_size"], spec["seconds"]
    on_card = device.startswith("cuda")
    wire = torch.device("cuda", rank) if on_card else torch.device("cpu")
    mark = stages.mark if stages is not None else (lambda name: None)
    logits, labels = seg.make_pool(rank_seed(spec["seed"], rank, world), cfg, traffic, device)
    seg.sync(device)
    mark("inputs")
    pool_bytes = torch.cuda.memory_allocated() if on_card else 0
    dist.init_process_group(cfg["backend"] if on_card else "gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    mark("group")
    patch = shared_faults.Patch()
    if spec["fault"] is not None:
        _plant(spec["fault"], patch, rank, world)
    try:
        collection = seg.build(cfg, device)
        mark("metric")
        plan = schedule(cfg, traffic)
        read_key = traffic["read_each_step"]

        def step(p: int, n: int):
            out = collection(logits[p][:n], labels[p][:n])
            float(out[read_key])  # the step's score over every rank's batch, read on the host
            return out

        # warm every shape of the pass, and every collective: the steps' and the pass end's syncs
        for p, n in sorted({(0, n) for _, n in plan}):
            out = step(p, n)
        res = collection.compute()
        step_slots = seg.HostSlots(out, seg.STEP_SLOTS, on_card)
        pass_slots = seg.HostSlots(seg.pass_record(res, collection), seg.PASS_SLOTS, on_card)
        del out, res
        collection.reset()
        mark("warm-up")
        prof = _trace_start(tracer, obs, on_card)
        flag = torch.zeros(1, dtype=torch.int32, device=wire)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)  # every rank warmed (and traced): the windows start together
        seg.sync(device)
        setup_s = time.perf_counter() - t0
        setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()

        counted = ("sync.bytes_gathered", "sync.preflight_bytes")
        bytes_before = _counter_total(obs, counted)
        kept: List[Tuple[int, int, int, int]] = []  # (pass, step of the pass, images, slot of the batch values)
        members = [m for _, m in collection.items()]
        step_s = sync_s = 0.0  # this rank's time in the steps, and in their syncs (the members' sync reports)
        pass_ends: List[float] = []
        passes = 0
        usage = _usage()
        start = time.perf_counter()
        with tracer.span("pb.window"):
            j = 0
            while True:
                p, n = plan[j]
                t = time.perf_counter()
                with tracer.span("pb.step"):
                    out = step(p, n)
                step_s += time.perf_counter() - t
                sync_s += sum((m.last_sync_report or {}).get("duration_secs", 0.0) for m in members)
                kept.append((passes, j, n, step_slots.put(out)))
                del out
                j += 1
                if j == len(plan):
                    with tracer.span("pb.compute"):
                        res = collection.compute()
                        float(res[read_key])  # the pass's score, read on the host
                        pass_slots.put(seg.pass_record(res, collection))
                        del res
                        collection.reset()
                    passes += 1
                    j = 0
                    flag.fill_(int(time.perf_counter() - start >= seconds))
                    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
                    pass_ends.append(time.perf_counter() - start)
                    if flag.item():
                        break
            seg.sync(device)
        window_s = time.perf_counter() - start
        usage = tuple(b - a for a, b in zip(usage, _usage()))
        _trace_stop(tracer, obs, prof)
        sync_bytes = _counter_total(obs, counted) - bytes_before
        window_peak = torch.cuda.max_memory_allocated() if on_card else 0
        partial = seg.states(collection)
        del collection, members
    finally:
        patch.undo()

    steps = [(i, j, n, step_slots.get(slot)) for i, j, n, slot in kept]
    done_passes = [seg.unpack_pass(pass_slots.get(slot)) for slot in range(passes)]
    keys = sorted(set(plan))
    local = ref_ddp.rank_confusions(logits, labels, keys, cfg["num_classes"])
    every = ref_ddp.gather_ranks(local, wire)  # (P, K, C, C) int64: each rank's reference confusions
    del logits, labels
    confs = {"local": dict(zip(keys, every[rank])), "global": dict(zip(keys, every.sum(0)))}
    got = judge(cfg, plan, confs, steps if rank == 0 else [], done_passes, partial, spec["limits"],
                values=rank == 0)
    got["rank_diff"] = float(_rank_diff(steps, done_passes, wire))
    row = [got[k] for k in CHECKS] + [got["failed"], got["attempted"], float(bool(forbidden_modules())),
                                      float(pool_bytes), float(setup_peak), float(window_peak), float(len(kept)),
                                      step_s, sync_s, *usage]
    rows = ref_ddp.gather_ranks(torch.tensor(row, dtype=torch.float64), wire)
    dist.destroy_process_group()
    if rank:
        return None
    if rows[:, 6].any():
        raise RuntimeError("a rank loaded jax, jaxlib, flax or metrics_tpu")
    if not bool((rows[:, 10] == rows[0, 10]).all()):
        raise RuntimeError(f"the ranks took different numbers of steps: {rows[:, 10].tolist()}")
    _print_window(rows, pass_ends)
    checks = {"count_diff": float(rows[:, 0].sum()), "miou_err": _worst(rows[:, 1]), "acc_err": _worst(rows[:, 2]),
              "rank_diff": float(rows[:, 3].sum())}
    images = sum(s[2] for s in steps)  # rank 0's own; each rank scores as many
    pixels = world * images * cfg["height"] * cfg["width"]
    metric_peak = float((rows[:, 9] - rows[:, 7]).max())
    return Outcome(
        setup_s=setup_s,
        end_to_end={"mpixels_per_s": pixels / window_s / 1e6, "metric_peak_mib": metric_peak / 2**20},
        counts={"images": images, "height": cfg["height"], "width": cfg["width"],
                "num_classes": cfg["num_classes"], "ranks": world, "steps": len(steps), "passes": passes,
                "sync_bytes": sync_bytes},
        memory_peak_bytes=int(rows[:, 8:10].max()),
        checks=sorted(checks.items()),
        attempted=int(rows[:, 5].sum()),
        failed=int(rows[:, 4].sum()),
        setup_stages=stages.seconds,
    )


def _print_window(rows: torch.Tensor, pass_ends: Sequence[float]) -> None:
    """Where each rank's window went, on standard error: its ms a step in the steps, in their syncs and
    outside them, its involuntary context switches and CPU seconds; and when each pass of rank 0 ended."""
    steps = float(rows[0, 10]) or 1.0

    def per_rank(values, fmt: str) -> str:
        return " ".join(fmt.format(float(v)) for v in values)

    print(f"portbench: window by rank: step ms {per_rank(rows[:, 11] / steps * 1e3, '{:.3f}')}"
          f" | sync ms {per_rank(rows[:, 12] / steps * 1e3, '{:.3f}')}"
          f" | outside sync ms {per_rank((rows[:, 11] - rows[:, 12]) / steps * 1e3, '{:.3f}')}"
          f" | involuntary switches {per_rank(rows[:, 13], '{:.0f}')} | cpu s {per_rank(rows[:, 14], '{:.2f}')}"
          f" | pass ends s {' '.join(f'{t:.3f}' for t in pass_ends)}", file=sys.stderr, flush=True)


def _worst(values: torch.Tensor) -> float:
    return float("nan") if bool(values.isnan().any()) else float(values.max())


def _counter_total(obs, names: Sequence[str]) -> float:
    return float(sum(v for (name, _), v in obs.counters_snapshot().items() if name in names))


def _trace_start(tracer, obs, on_card: bool):
    """With tracing on, the port's spans and a profiler over the window, as ``tools/port_span_probe.py``
    records them."""
    if not tracer.enabled:
        return None
    obs.enable()
    acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if on_card else [])
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def _trace_stop(tracer, obs, prof) -> None:
    if prof is None:
        return
    obs.disable()
    prof.__exit__(None, None, None)
    tracer.trace = port_spans.reduce_events(prof.profiler.kineto_results.events())


def _bits(values: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """Each value's bits as int64, in a fixed order: floats by their bit patterns, counts as they are."""
    out = []
    for key in sorted(values, key=str):
        t = values[key].reshape(-1)
        if t.is_floating_point():
            t = t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
        out.append(t.to(torch.int64))
    return out


def _rank_diff(steps, passes, wire: torch.device) -> int:
    """On rank 0, the answers of the other ranks that differ in a bit from its own (each step's batch values
    and each pass's ``compute()``; the states are each rank's own); elsewhere 0."""
    parts = [b for *_, out in steps for b in _bits(out)] + [b for res, _ in passes for b in _bits(res)]
    mine = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int64)
    sizes = ref_ddp.gather_ranks(torch.tensor([mine.numel()]), wire).reshape(-1)
    longest = int(sizes.max())
    padded = torch.cat([mine, torch.full((longest - mine.numel(),), -1, dtype=torch.int64)])
    every = ref_ddp.gather_ranks(padded, wire)
    if dist.get_rank():
        return 0
    return int((every[1:] != every[0]).sum()) + int((sizes[1:] - sizes[0]).abs().sum())


def judge(cfg, plan, confs, steps, passes, partial, limits, values: bool) -> Dict[str, float]:
    """One rank's answers against the reference: with ``values``, each step's batch values against the
    sum over the ranks of that step's confusions (``confs["global"]``) and each pass's ``compute()``
    against the sum over its images; each pass's states and the unfinished state against this rank's own
    (``confs["local"]``).  Returns the numbers compared (each the worst over the window), the answers
    compared and those outside a limit."""
    average = seg._average(cfg, "Accuracy")
    prefix = {"local": [torch.zeros_like(confs["local"][plan[0]])], "global": [torch.zeros_like(confs["global"][plan[0]])]}
    for key in plan:
        for side in prefix:
            prefix[side].append(prefix[side][-1] + confs[side][key])
    worst = {"count_diff": 0.0, "miou_err": 0.0, "acc_err": 0.0}
    tally = {"failed": 0, "attempted": 0}

    def score(got: Dict[str, Any], want_cm: torch.Tensor) -> Dict[str, float]:
        want = ref_ddp.answers(want_cm, average)
        return {"count_diff": float(seg._count_diff(got["ConfusionMatrix"], want_cm)),
                "miou_err": seg._rel(float(got["JaccardIndex"]), want["JaccardIndex"]),
                "acc_err": seg._rel(float(got["Accuracy"]), want["Accuracy"])}

    def state_diff(snap: Dict[str, Dict[str, torch.Tensor]], want_cm: torch.Tensor) -> float:
        counts = ref.stat_counts(want_cm, average)
        diff = 0
        for st in snap.values():
            for key, value in st.items():
                want = want_cm if key == "confmat" else counts.get(key)
                if want is not None:
                    diff += seg._count_diff(value, want)
        return float(diff)

    def fold(got: Dict[str, float]) -> None:
        bad = False
        for k, v in got.items():
            worst[k] = max(worst[k], v) if v == v else float("nan")
            bad |= not (v <= limits.get(k, -1.0))
        tally["failed"] += bad
        tally["attempted"] += 1

    if values:
        for _, j, _, out in steps:
            fold(score(out, confs["global"][plan[j]]))
    for res, snap in passes:
        got = score(res, prefix["global"][-1]) if values else {"count_diff": 0.0}
        got["count_diff"] += state_diff(snap, prefix["local"][-1])
        fold(got)
    # the window ends at a pass end: the unfinished pass is the state reset() left
    fold({"count_diff": state_diff(partial, prefix["local"][0])})
    return {**worst, **{k: float(v) for k, v in tally.items()}}


def control(cell, seed: int, device: str, limits: Dict[str, float]):
    """The numbers compared, with the reference one step below the stated precision (bfloat16 logits) in
    the program's place over one whole pass of every rank's inputs, the ranks' pools made one at a time."""
    cfg, traffic = cell.config, cell.traffic
    world, classes = cfg["world_size"], cfg["num_classes"]
    plan = schedule(cfg, traffic)
    keys = sorted(set(plan))
    exact, low = [], []
    for rank in range(world):
        logits, labels = seg.make_pool(rank_seed(seed, rank, world), cfg, traffic, device)
        exact.append(ref_ddp.rank_confusions(logits, labels, keys, classes).cpu())
        low.append(ref_ddp.rank_confusions([x.to(torch.bfloat16) for x in logits], labels, keys, classes).cpu())
        del logits, labels
    average = seg._average(cfg, "Accuracy")
    low_global = {key: sum(r[i] for r in low) for i, key in enumerate(keys)}

    def snap(total: torch.Tensor):
        counts = ref.stat_counts(total, average)
        return {m["class"]: ({"confmat": total} if m["class"] != "Accuracy" else counts) for m in cfg["metrics"]}

    totals = [sum(r[keys.index(key)] for key in plan) for r in low]
    steps = [(0, j, n, ref_ddp.answers(low_global[(p, n)], average)) for j, (p, n) in enumerate(plan)]
    partial = snap(torch.zeros(classes, classes, dtype=torch.int64))
    rows = []
    for rank in range(world):
        confs = {"local": dict(zip(keys, exact[rank])), "global": dict(zip(keys, sum(exact)))}
        res = ref_ddp.answers(sum(totals), average)
        rows.append(judge(cfg, plan, confs, steps if rank == 0 else [], [(res, snap(totals[rank]))], partial,
                          limits, values=rank == 0))
    checks = {"count_diff": sum(r["count_diff"] for r in rows), "miou_err": max(r["miou_err"] for r in rows),
              "acc_err": max(r["acc_err"] for r in rows), "rank_diff": 0.0}
    return sorted(checks.items()), int(sum(r["attempted"] for r in rows)), int(sum(r["failed"] for r in rows))
