"""One run of one cell: the task's set-up and window, the readings, and the result line."""

import json
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from portbench.cell import Cell, peaks
from portbench.tracing import Trace, Tracer


@dataclass
class Outcome:
    """What a task hands back once its window has closed and its answers were judged."""

    setup_s: float
    end_to_end: Dict[str, float]
    counts: Dict[str, float]
    memory_peak_bytes: int
    checks: List[Tuple[str, float]]  # (number compared, its reading); the limit is the cell's
    attempted: int
    failed: int
    setup_stages: Dict[str, float] = field(default_factory=dict)  # seconds of each stage of the set-up


class Stages:
    """Seconds of each stage of a set-up, from the process's start."""

    def __init__(self, t0: float) -> None:
        self.last = t0
        self.seconds: Dict[str, float] = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.last
        self.last = now


@dataclass
class Reading:
    """What a per-layer metric's reader may take: the reduced trace of the window, the task's counts,
    the cell and the table of peaks."""

    trace: Optional[Trace]
    outcome: Outcome
    cell: Cell
    peaks: Dict[str, float]


def within(value: float, limit: Optional[float]) -> bool:
    return limit is not None and not math.isnan(value) and value <= limit


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t0: float) -> Dict[str, Any]:
    import torch

    # the configurations state float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tracer = Tracer(trace)
    limits = cell.limits()
    out: Outcome = cell.task().run(cell, seed=seed, seconds=seconds, tracer=tracer, device=device, t0=t0,
                                   limits=limits)
    metrics: Dict[str, Dict[str, Any]] = {}
    if trace:
        reading = Reading(tracer.trace, out, cell, peaks())
        for m in cell.per_layer():
            value = cell.reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**out.end_to_end, "setup_s": out.setup_s}
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    on_gpu = device.startswith("cuda")
    info: Dict[str, Any] = {
        "platform": "gpu" if on_gpu else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_gpu else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": out.memory_peak_bytes,
    }
    result: Dict[str, Any] = {}
    if trace and tracer.trace is not None:
        lo, hi = tracer.trace.window()
        info["busy_s"] = tracer.trace.window_busy_ns() / 1e9
        info["window_s"] = (hi - lo) / 1e9
        result["breakdown"] = tracer.trace.breakdown()
    checks = {name: {"value": value, "limit": limits.get(name)} for name, value in out.checks}
    correct = out.failed == 0 and all(within(c["value"], c["limit"]) for c in checks.values())
    stages = " ".join(f"{k} {v:.3f}" for k, v in out.setup_stages.items())
    print(f"set-up stages (s): {stages}", file=sys.stderr)
    return {"correct": correct, "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
            "device": info, **result, "checks": checks}


def emit(result: Dict[str, Any]) -> None:
    """The numbers compared, each beside its limit, as the last lines on standard error; then the result
    as the last line on standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']} attempted {result['attempted']} failed {result['failed']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
