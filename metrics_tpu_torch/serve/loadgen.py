"""Reusable load generation for the serve tier: threads or processes
(counterpart of ``metrics_tpu/serve/loadgen.py``: the same batches).

The soak harness had a one-off traffic pusher; this module promotes it
into the load generator the fleet bench and the chaos drills share:

* :func:`run_load` — **thread mode**: N in-process producer threads push
  deterministic columnar batches through any ``ingest(lo, hi) ->
  (accepted, rejected)`` callable (a worker's ``submit_columns``, a
  coordinator's ``ingest_columns``, an :class:`HTTPShard` forward — the
  callable decides), while an optional query thread samples read latency
  the whole time.  Returns a :class:`LoadReport` with records/s and query
  p50/p99.
* :func:`run_process_load` — **process mode**: spawns stdlib-only child
  processes (this package's own ``_loadgen_child.py``, executed by path
  so children never pay the package import) that POST JSON ``/ingest`` batches at a real
  HTTP endpoint; reports aggregate across children.
* :class:`ColumnTraffic` — counter-keyed batch synthesis (one Philox
  stream per ``(seed, lo)``): batch ``[lo, hi)`` is the same bytes in
  every process, so drills can split ranges across producers and still
  reason about exactly which rows landed.
"""
# analyze: skip-file[serve-blocking] -- load generator: it runs in
# the operator/bench process and deliberately blocks on the service under
# test (joins, HTTP round-trips), like the soak harness it grew out of.

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from metrics_tpu_torch.obs import core as _obs
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

__all__ = ["ColumnTraffic", "LoadReport", "run_load", "run_process_load"]

_CHILD_PATH = os.path.join(os.path.dirname(__file__), "_loadgen_child.py")


class ColumnTraffic:
    """Deterministic columnar batches: ``batch(lo, hi)`` is a pure
    function of ``(seed, lo, hi)`` — counter-keyed like
    :class:`~metrics_tpu_torch.serve.traffic.TrafficGenerator`, but vectorized
    (one Philox draw per batch, not per record)."""

    def __init__(
        self,
        job: str,
        arity: int = 2,
        num_streams: Optional[int] = None,
        seed: int = 0,
        dyadic: bool = False,
    ) -> None:
        self.job = job
        self.arity = int(arity)
        self.num_streams = num_streams
        self.seed = int(seed)
        # dyadic quantization (multiples of 1/8) makes float32 accumulation
        # exact no matter how rows are grouped into blocks — required by
        # drills that compare fleets with DIFFERENT shardings bitwise
        # (same-sharding twins match without it: their block boundaries,
        # and so their partial-sum trees, are identical anyway)
        self.dyadic = bool(dyadic)

    def batch(
        self, lo: int, hi: int
    ) -> Tuple[List[np.ndarray], Optional[np.ndarray]]:
        n = int(hi) - int(lo)
        if n <= 0:
            raise MetricsTPUUserError(f"empty batch [{lo}, {hi})")
        rng = np.random.Generator(
            np.random.Philox(key=self.seed, counter=[0, 0, 0, int(lo)])
        )
        cols = [
            rng.random(n, dtype=np.float32) for _ in range(self.arity)
        ]
        if self.dyadic:
            cols = [np.floor(c * 8.0).astype(np.float32) / 8.0 for c in cols]
        ids = None
        if self.num_streams is not None:
            ids = rng.integers(0, self.num_streams, n).astype(np.int32)
        return cols, ids


@dataclass
class LoadReport:
    """What a load run measured (ingest throughput + read latency)."""

    records: int = 0
    accepted: int = 0
    rejected: int = 0
    elapsed_s: float = 0.0
    query_count: int = 0
    query_p50_ms: float = 0.0
    query_p99_ms: float = 0.0
    query_errors: int = 0
    errors: List[str] = field(default_factory=list)

    @property
    def records_per_s(self) -> float:
        return self.records / self.elapsed_s if self.elapsed_s > 0 else 0.0

    def merge(self, other: "LoadReport") -> "LoadReport":
        """Aggregate a child's report into this one (wall time = max:
        children run concurrently)."""
        self.records += other.records
        self.accepted += other.accepted
        self.rejected += other.rejected
        self.elapsed_s = max(self.elapsed_s, other.elapsed_s)
        self.errors.extend(other.errors)
        return self


def _percentile_ms(latencies_s: List[float], q: float) -> float:
    if not latencies_s:
        return 0.0
    return float(np.percentile(np.asarray(latencies_s), q) * 1e3)


def run_load(
    ingest: Callable[[int, int], Tuple[int, int]],
    total_records: int,
    batch_rows: int = 256,
    threads: int = 1,
    query: Optional[Callable[[], Any]] = None,
    query_interval: float = 0.002,
    flush: Optional[Callable[[], bool]] = None,
) -> LoadReport:
    """Thread-mode load: push ``total_records`` through ``ingest`` and
    (optionally) sample ``query`` latency until ingest completes.

    ``ingest(lo, hi)`` owns batch synthesis and delivery (pair it with a
    :class:`ColumnTraffic`); producer ``threads`` split the record range
    into interleaved batch slots.  ``flush`` (when given) runs inside the
    timed window — throughput then measures records *applied to state*,
    not records parked in queues.
    """
    total = int(total_records)
    if total <= 0:
        raise MetricsTPUUserError(f"total_records must be > 0, got {total}")
    batch_rows = max(1, int(batch_rows))
    n_batches = (total + batch_rows - 1) // batch_rows
    report = LoadReport()
    report_lock = threading.Lock()

    def produce(worker: int) -> None:
        accepted = rejected = sent = 0
        for b in range(worker, n_batches, max(1, int(threads))):
            lo = b * batch_rows
            hi = min(lo + batch_rows, total)
            try:
                got, lost = ingest(lo, hi)
            except Exception as err:  # noqa: BLE001 — a failed batch is data
                with report_lock:
                    report.errors.append(f"ingest[{lo}:{hi}): {err}")
                continue
            sent += hi - lo
            accepted += int(got)
            rejected += int(lost)
        with report_lock:
            report.records += sent
            report.accepted += accepted
            report.rejected += rejected

    producers = [
        threading.Thread(target=produce, args=(w,), name=f"loadgen-{w}")
        for w in range(max(1, int(threads)))
    ]
    latencies: List[float] = []
    q_errors = [0]
    done = threading.Event()

    def query_loop() -> None:
        while not done.is_set():
            t0 = time.monotonic()
            try:
                query()
                latencies.append(time.monotonic() - t0)
            except Exception:  # noqa: BLE001 — latency sampling must not die
                q_errors[0] += 1
            done.wait(query_interval)

    sampler = (
        threading.Thread(target=query_loop, name="loadgen-query")
        if query is not None
        else None
    )
    t0 = time.monotonic()
    for t in producers:
        t.start()
    if sampler is not None:
        sampler.start()
    for t in producers:
        t.join()
    if flush is not None and not flush():
        report.errors.append("flush timed out")
    report.elapsed_s = time.monotonic() - t0
    done.set()
    if sampler is not None:
        sampler.join(timeout=5.0)
    report.query_count = len(latencies)
    report.query_errors = q_errors[0]
    report.query_p50_ms = _percentile_ms(latencies, 50.0)
    report.query_p99_ms = _percentile_ms(latencies, 99.0)
    _obs.counter_inc("serve.loadgen_runs")
    return report


def run_process_load(
    url: str,
    job: str,
    total_records: int,
    processes: int = 2,
    batch_rows: int = 256,
    arity: int = 2,
    num_streams: Optional[int] = None,
    seed: int = 0,
    timeout: float = 120.0,
) -> LoadReport:
    """Process-mode load: stdlib-only children POST ``/ingest`` at ``url``.

    Children are real processes (their GILs don't share ours), launched by
    file path so none of them pays the package import.  The record range
    splits contiguously across children; each prints a JSON report line
    this parent aggregates.
    """
    total = int(total_records)
    processes = max(1, int(processes))
    per = (total + processes - 1) // processes
    procs: List[subprocess.Popen] = []
    for w in range(processes):
        lo, hi = w * per, min((w + 1) * per, total)
        if lo >= hi:
            break
        cmd = [
            sys.executable,
            _CHILD_PATH,
            "--url", url,
            "--job", job,
            "--lo", str(lo),
            "--hi", str(hi),
            "--batch-rows", str(int(batch_rows)),
            "--arity", str(int(arity)),
            "--num-streams", str(int(num_streams or 0)),
            "--seed", str(int(seed)),
        ]
        procs.append(
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE
            )
        )
    report = LoadReport()
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            report.errors.append("loadgen child timed out")
            continue
        if proc.returncode != 0:
            report.errors.append(
                f"loadgen child rc={proc.returncode}: {err.decode()[-200:]}"
            )
            continue
        child = json.loads(out.decode().strip().splitlines()[-1])
        report.merge(
            LoadReport(
                records=int(child["sent"]),
                accepted=int(child["accepted"]),
                rejected=int(child["rejected"]),
                elapsed_s=float(child["elapsed_s"]),
                errors=(
                    [f"child http errors: {child['errors']}"]
                    if child.get("errors")
                    else []
                ),
            )
        )
    _obs.counter_inc("serve.loadgen_runs")
    return report
