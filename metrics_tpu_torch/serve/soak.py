"""Soak harness: sustained traffic, fault injection, kill→restore drill
(counterpart of ``metrics_tpu/serve/soak.py``).

The contract being drilled: an :class:`EvalServer` that dies mid-stream and
restarts from its last committed checkpoint, then replays traffic from the
record index that checkpoint covered, ends **bit-identical** to a server
that never died.  That holds because every layer below is deterministic:

* traffic is counter-keyed (record ``i`` is a pure function of the seed),
* block dispatch boundaries depend only on record order (capacity flushes
  plus explicit flushes at fixed record indices — the soak config turns the
  wall-clock interval flush off, since EMA jobs fold per update *call*),
* padded multistream rows are dropped on device, and
* the checkpoint codec round-trips state exactly.

Faults ride along without breaking any of it: a :class:`ChaosStore` tears
an early manifest (the durability path must survive a failed commit and
retry), and a :class:`ChaosBackend` faults an explicit operator sync whose
``on_sync_error="local"`` policy keeps local values — local state is
untouched, so determinism survives.

The drill's metrics keep their state on ``device`` (``"cuda"`` by default,
raising without CUDA; ``"cpu"`` when asked).  ``python -m
metrics_tpu_torch.serve.soak [--device cpu]`` runs the drill standalone.
"""
# analyze: skip-file[serve-blocking] -- the soak harness is an operator/test
# tool, not a request path: it deliberately wires checkpoint stores, chaos
# backends, and explicit operator syncs around the server.

from __future__ import annotations

import argparse
import json
import threading
import time
import urllib.request
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from metrics_tpu_torch.checkpoint import CheckpointManager, ChaosStore, LocalStore
from metrics_tpu_torch.obs import core as _obs
from metrics_tpu_torch.parallel import ChaosBackend, LoopbackBackend
from metrics_tpu_torch.multistream import MultiStreamMetric
from metrics_tpu_torch.regression import MeanSquaredError
from metrics_tpu_torch.serve.ingest import BlockBatcher
from metrics_tpu_torch.serve.registry import MetricRegistry
from metrics_tpu_torch.serve.server import EvalServer, ServeConfig
from metrics_tpu_torch.serve.traffic import JobTraffic, TrafficGenerator
from metrics_tpu_torch.streaming import StreamingQuantile, TimeDecayedMetric, WindowedMetric
from metrics_tpu_torch.utils.exceptions import CheckpointError

__all__ = [
    "make_soak_registry",
    "make_soak_traffic",
    "run_uninterrupted",
    "run_drill",
    "ResponsivenessPoller",
    "DrillResult",
    "trees_bitwise_equal",
]

_SOAK_STREAMS = 32


def make_soak_registry(
    num_streams: int = _SOAK_STREAMS, device: str = "cuda"
) -> MetricRegistry:
    """One job of every serve kind, all fed by :func:`make_soak_traffic`,
    every one on ``device``."""
    on = {"device": device}
    registry = MetricRegistry()
    registry.register("mse", MeanSquaredError(**on))
    registry.register(
        "quantiles", StreamingQuantile(q=(0.5, 0.99), **on), components=("p50", "p99")
    )
    registry.register(
        "window_mse", WindowedMetric(MeanSquaredError(**on), window_size=4, **on)
    )
    registry.register(
        "decayed_mse",
        TimeDecayedMetric(MeanSquaredError(**on), half_life=50.0, **on),
    )
    registry.register(
        "per_tenant",
        MultiStreamMetric(MeanSquaredError(**on), num_streams=num_streams, **on),
        export_top_k=3,
    )
    return registry


def make_soak_traffic(seed: int = 7, num_streams: int = _SOAK_STREAMS) -> TrafficGenerator:
    """Record schedule matching :func:`make_soak_registry` job-for-job."""
    return TrafficGenerator(
        [
            JobTraffic("mse", arity=2),
            JobTraffic("quantiles", arity=1),
            JobTraffic("window_mse", arity=2),
            JobTraffic("decayed_mse", arity=2),
            JobTraffic("per_tenant", arity=2, num_streams=num_streams, oob_every=13),
        ],
        seed=seed,
    )


def run_uninterrupted(
    traffic: TrafficGenerator,
    n: int,
    flush_points: Tuple[int, ...] = (),
    block_rows: int = 64,
    num_streams: int = _SOAK_STREAMS,
    device: str = "cuda",
) -> Dict[str, Any]:
    """Feed records ``0..n-1`` straight into batchers — the reference run.

    ``flush_points`` are the record counts at which the drilled server
    flushes (its checkpoints); the reference must flush at the same indices
    because flush boundaries are update-call boundaries for EMA jobs.
    """
    registry = make_soak_registry(num_streams=num_streams, device=device)
    batchers = {
        job.name: BlockBatcher(job, block_rows=block_rows) for job in registry.jobs()
    }
    points = set(int(p) for p in flush_points)
    for i in range(n):
        rec = traffic.record(i)
        batchers[rec.job].add(rec)
        if i + 1 in points:
            for b in batchers.values():
                b.flush()
    for b in batchers.values():
        b.flush()
    return registry.compute_all()


class ResponsivenessPoller:
    """Background thread asserting the HTTP surface stays live under load.

    Hits ``/healthz``, ``/metrics`` and ``/query`` in a loop, recording
    per-request latencies and any non-2xx/connection failure.  The drill
    asserts ``failures == []`` — the service never went dark while
    ingesting, checkpointing, or surviving store faults.
    """

    def __init__(self, port: int, query_job: str = "mse", interval: float = 0.02) -> None:
        self._base = f"http://127.0.0.1:{port}"
        self._paths = ["/healthz", "/metrics", f"/query?job={query_job}"]
        self.interval = float(interval)
        self.latencies: List[float] = []
        self.failures: List[str] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="soak-poller", daemon=True
        )

    def start(self) -> "ResponsivenessPoller":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10.0)

    def _run(self) -> None:
        i = 0
        while not self._stop.is_set():
            path = self._paths[i % len(self._paths)]
            i += 1
            t0 = time.monotonic()
            try:
                with urllib.request.urlopen(self._base + path, timeout=5.0) as resp:
                    resp.read()
                    if resp.status >= 400:
                        self.failures.append(f"{path}: HTTP {resp.status}")
            except Exception as err:  # noqa: BLE001 — any failure is a finding
                self.failures.append(f"{path}: {type(err).__name__}: {err}")
            self.latencies.append(time.monotonic() - t0)
            self._stop.wait(self.interval)

    def summary(self) -> Dict[str, Any]:
        lat = sorted(self.latencies)
        pct = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))] if lat else 0.0  # noqa: E731
        return {
            "requests": len(lat),
            "failures": len(self.failures),
            "p50_ms": round(pct(0.50) * 1e3, 3),
            "p99_ms": round(pct(0.99) * 1e3, 3),
        }


def exercise_chaos_sync(registry: MetricRegistry, job: str = "mse") -> Dict[str, Any]:
    """Fire one explicit operator sync through a faulting backend.

    Read paths never sync (the registry forces that off), so the collective
    fault surface in a serving process is exactly this: an operator-driven
    ``sync`` that must degrade to local values instead of corrupting state
    or crashing the service.  Returns the sync report for assertions.
    """
    metric = registry[job].metric
    backend = ChaosBackend(
        LoopbackBackend(), schedule={0: "error"}, fault_exception="sync_error"
    )
    previous = metric.on_sync_error
    metric.on_sync_error = "local"
    try:
        with registry[job].lock:
            # sync_context unsyncs on exit only if the sync actually cached
            # state — robust across the "local"/"skip" fallback paths
            with metric.sync_context(backend=backend):
                pass
    finally:
        metric.on_sync_error = previous
    report = dict(metric.last_sync_report or {})
    return report


def _leaf(value: Any) -> Any:
    """A tensor leaf on the host, widened to float32 where numpy has no dtype
    for it (bfloat16): widening keeps every value's bits apart, NaNs too."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.numpy()
    return value


def trees_bitwise_equal(a: Any, b: Any) -> bool:
    """Exact (bit-level for floats, NaN==NaN) equality of nested computes.

    Leaves may be torch tensors on any device, numpy arrays or the jsonable
    floats a handle returns; each widens to float64 and compares bit for
    bit, so NaNs match only with the same sign and payload (the card's NaN
    is not the CPU's).
    """
    a, b = _leaf(a), _leaf(b)
    if isinstance(a, dict) or isinstance(b, dict):
        return (
            isinstance(a, dict)
            and isinstance(b, dict)
            and a.keys() == b.keys()
            and all(trees_bitwise_equal(a[k], b[k]) for k in a)
        )
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (
            isinstance(a, (list, tuple))
            and isinstance(b, (list, tuple))
            and len(a) == len(b)
            and all(trees_bitwise_equal(x, y) for x, y in zip(a, b))
        )
    fa = np.asarray(a, np.float64)
    fb = np.asarray(b, np.float64)
    return fa.shape == fb.shape and bool(
        np.all(fa.view(np.uint64) == fb.view(np.uint64))
    )


@dataclass
class DrillResult:
    """Everything the kill→restore drill observed, for test assertions."""

    identical: bool
    checkpoint_step: int
    restored_step: int
    final_step: Optional[int]
    checkpoint_failures: int
    chaos_injected: List[Tuple[str, str]]
    sync_report: Dict[str, Any]
    poller_failures: List[str] = field(default_factory=list)
    poller_summary: Dict[str, Any] = field(default_factory=dict)
    baseline: Dict[str, Any] = field(default_factory=dict)
    recovered: Dict[str, Any] = field(default_factory=dict)


def _submit_range(server: EvalServer, traffic: TrafficGenerator, lo: int, hi: int) -> None:
    for rec in traffic.replay(lo, hi):
        ok = server.submit(rec.job, rec.values, stream_id=rec.stream_id, timeout=5.0)
        if not ok:
            raise RuntimeError(f"soak submit rejected at record {rec!r}")


def _checkpoint_with_retry(server: EvalServer, tries: int = 5) -> Tuple[int, int]:
    """Commit a checkpoint, riding out injected store faults; returns
    ``(step, failures)`` — the durability loop's survive-and-retry contract,
    exercised synchronously so the drill stays record-deterministic."""
    failures = 0
    for _ in range(tries):
        try:
            return server.checkpoint_now(), failures
        except CheckpointError:
            failures += 1
            _obs.counter_inc("serve.checkpoint_failures")
    raise CheckpointError(f"checkpoint still failing after {tries} attempts")


def run_drill(
    directory: str,
    n: int = 1500,
    k: int = 900,
    lost_tail: int = 15,
    seed: int = 7,
    block_rows: int = 64,
    num_streams: int = _SOAK_STREAMS,
    store_faults: Optional[List[Tuple[str, str]]] = None,
    poll: bool = True,
    device: str = "cuda",
) -> DrillResult:
    """The kill→restore drill.

    Phase 1: serve records ``0..k``, checkpoint (through a fault-injecting
    store when ``store_faults`` is set), ingest ``lost_tail`` more records
    that never flush, then ``kill()`` — those tail records are lost, as a
    preemption would lose them.

    Phase 2: a fresh server restores from the checkpoint, replays records
    ``k..n`` (the lost tail re-submitted first, exactly once), and drains
    through the graceful path with a final checkpoint.

    Reference: one uninterrupted run over ``0..n`` with a flush at ``k``.
    ``identical`` is the bit-level comparison of every job's compute.
    Every server and the reference keep their state on ``device``.
    """
    if store_faults is None:
        store_faults = [("torn_write", "MANIFEST")]
    config = ServeConfig(
        block_rows=block_rows,
        # wall-clock flushes off: dispatch boundaries must be a function of
        # record indices alone for the bit-exact comparison to be fair
        flush_interval=3600.0,
        queue_capacity=max(4096, n),
    )
    traffic = make_soak_traffic(seed=seed, num_streams=num_streams)

    # ----- phase 1: serve, checkpoint under faults, lose the tail, die
    store = ChaosStore(LocalStore(directory), faults=list(store_faults))
    mgr_a = CheckpointManager(store=store, keep_last=None)
    server_a = EvalServer(
        make_soak_registry(num_streams=num_streams, device=device), config, mgr_a
    ).start()
    poller = ResponsivenessPoller(server_a.port).start() if poll else None
    sync_report: Dict[str, Any] = {}
    try:
        _submit_range(server_a, traffic, 0, k)
        server_a.flush()
        sync_report = exercise_chaos_sync(server_a.registry)
        step, ckpt_failures = _checkpoint_with_retry(server_a)
        _submit_range(server_a, traffic, k, k + lost_tail)
    finally:
        if poller is not None:
            poller.stop()
        server_a.kill()

    # ----- phase 2: restore, replay the rest, drain gracefully
    mgr_b = CheckpointManager(directory, keep_last=None)
    server_b = EvalServer(
        make_soak_registry(num_streams=num_streams, device=device), config, mgr_b
    ).start()
    poller2 = ResponsivenessPoller(server_b.port).start() if poll else None
    try:
        restored = server_b.restored_step
        if restored != step:
            raise RuntimeError(f"restored step {restored!r} != committed step {step}")
        _submit_range(server_b, traffic, k, n)
    finally:
        if poller2 is not None:
            poller2.stop()
    final_step = server_b.stop(final_checkpoint=True)
    recovered = server_b.registry.compute_all()

    # ----- reference: never died, flushed at the same record index
    baseline = run_uninterrupted(
        traffic,
        n,
        flush_points=(k,),
        block_rows=block_rows,
        num_streams=num_streams,
        device=device,
    )

    failures = list(poller.failures if poller else []) + list(
        poller2.failures if poller2 else []
    )
    summary: Dict[str, Any] = {}
    if poller is not None and poller2 is not None:
        summary = {"phase1": poller.summary(), "phase2": poller2.summary()}
    return DrillResult(
        identical=trees_bitwise_equal(baseline, recovered),
        checkpoint_step=step,
        restored_step=restored,
        final_step=final_step,
        checkpoint_failures=ckpt_failures,
        chaos_injected=list(store.injected),
        sync_report=sync_report,
        poller_failures=failures,
        poller_summary=summary,
        baseline=baseline,
        recovered=recovered,
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    import tempfile

    parser = argparse.ArgumentParser(
        prog="python -m metrics_tpu_torch.serve.soak",
        description="the kill→restore soak drill",
    )
    parser.add_argument(
        "--device", default="cuda", help="cuda (the default) or cpu"
    )
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        result = run_drill(tmp, device=args.device)
    payload = {
        "identical": result.identical,
        "checkpoint_step": result.checkpoint_step,
        "restored_step": result.restored_step,
        "final_step": result.final_step,
        "checkpoint_failures": result.checkpoint_failures,
        "chaos_injected": result.chaos_injected,
        "poller": result.poller_summary,
        "poller_failures": result.poller_failures[:5],
    }
    print(json.dumps(payload, indent=2, default=str))
    return 0 if result.identical and not result.poller_failures else 1


if __name__ == "__main__":
    raise SystemExit(main())
