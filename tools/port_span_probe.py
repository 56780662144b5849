"""One traced run of a benchmark cell with the port's own spans in the profiler's trace, split by layer.

Run from the root of a checkout, on a machine with the card(s) the cell asks for:

    python3 tools/port_span_probe.py --workload <cell> --seed <n> --seconds <s> [--spans 0|1] [--out <file>]

It runs ``portbench/run.py``'s own ``main`` with ``--trace 1``, its tracer replaced by :class:`PortTracer`,
which turns ``metrics_tpu_torch.obs`` on over the window so that every span of the port
(``collection.forward``, ``metric.forward``, ``metric.update_impl``, ``validation.*``, ``extractor.forward``,
...) is a user annotation on the trace's clock.  ``--spans 0`` keeps the harness's own tracer, with the
port's spans off, for the cost of the annotations on the same seed.  The run's result line comes first on
standard output, as ``run.py`` prints it; then one JSON line with the per-layer readings of
:func:`portbench.port_spans.readings`, a segmentation step split by layer (:func:`step_split`), the window's
device-idle time by the innermost port span open on the host (:func:`idle_by_span`), and the span counts;
``--out`` also writes it to a file.
"""

import argparse
import bisect
import json
import os
import sys
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import portbench.run as pbrun  # noqa: E402  (set-up counts from this import, as in a run by path)
from portbench import harness, port_spans, tracing  # noqa: E402
from portbench.port_spans import VALIDATION, idle_gaps, is_host_read, launched_in, self_host_ns  # noqa: E402
from portbench.tracing import Trace  # noqa: E402


class PortTracer(tracing.Tracer):
    """The harness's tracer with the port's spans on over the traced window, reduced by
    :func:`portbench.port_spans.reduce_events`."""

    def start(self) -> None:
        if self.enabled:
            from metrics_tpu_torch import obs

            obs.enable()
        super().start()

    def stop(self) -> None:
        if self._prof is not None:
            from metrics_tpu_torch import obs

            obs.disable()
            self._prof.__exit__(None, None, None)
            self.trace = port_spans.reduce_events(self._prof.profiler.kineto_results.events())
            self._prof = None


def port_span_names(trace: Trace) -> List[str]:
    return sorted(n for n in trace.ranges if not n.startswith("pb."))


def idle_by_span(trace: Trace) -> Dict[str, int]:
    """Idle time of the window by the innermost port span open on the host at each gap's middle (the
    latest-started one that holds it; ``""`` where none is open)."""
    out: Dict[str, int] = {}
    names = port_span_names(trace)
    for a, b in idle_gaps(trace):
        mid, holding = (a + b) // 2, []
        for name in names:
            spans = trace.spans(name)
            i = bisect.bisect_right(spans, (mid, float("inf"))) - 1
            if i >= 0 and spans[i][0] <= mid <= spans[i][1]:
                holding.append((spans[i][0], name))
        name = max(holding)[1] if holding else ""
        out[name] = out.get(name, 0) + b - a
    return out


def step_split(trace: Trace) -> Dict[str, Dict[str, float]]:
    """A segmentation step by layer: host ms (self times that partition the step's host time), device ms
    and reads to the host, each over the window's steps; empty without steps."""
    steps = len(trace.spans("pb.step"))
    if not steps:
        return {}
    s, v = "pb.step", VALIDATION
    parts = {  # (spans, children: their self time and launches are left out)
        "collection": (["collection.forward"], ["metric.forward"]),
        "core": (["metric.forward"], ["metric.update_impl", *v]),
        "validation": (list(v), []),
        "update_body_outside_validation": (["metric.update_impl"], list(v)),
        "harness": (["pb.step"], ["collection.forward"]),
    }
    host = {k: self_host_ns(trace, names, kids, s) / steps / 1e6 for k, (names, kids) in parts.items()}
    launched = {k: launched_in(trace, names, kids, s) for k, (names, kids) in parts.items()}
    launched["batch_value_compute"] = launched_in(trace, ["metric.compute"], v, s)
    return {
        "host_ms": host,
        "device_ms": {k: trace.busy_ns(ops) / steps / 1e6 for k, ops in launched.items()},
        "reads": {k: sum(is_host_read(op) for op in ops) / steps for k, ops in launched.items()},
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", required=True)
    parser.add_argument("--seconds", required=True)
    parser.add_argument("--spans", type=int, choices=(0, 1), default=1)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    tracers = []

    class Kept(PortTracer if args.spans else tracing.Tracer):
        def __init__(self, enabled: bool) -> None:
            super().__init__(enabled)
            tracers.append(self)

    harness.Tracer = Kept
    rc = pbrun.main(["--workload", args.workload, "--seed", args.seed, "--seconds", args.seconds, "--trace", "1"])
    trace = tracers[-1].trace if tracers else None
    if rc or trace is None:
        return rc or 1
    split = {
        "workload": args.workload,
        "seed": args.seed,
        "spans": bool(args.spans),
        "readings": port_spans.readings(trace, args.workload),
        "step_split": step_split(trace),
        "idle_s": sum(b - a for a, b in idle_gaps(trace)) / 1e9,
        "idle_by_span_s": {k: v / 1e9 for k, v in sorted(idle_by_span(trace).items(), key=lambda kv: -kv[1])},
        "span_counts": {n: len(trace.spans(n)) for n in sorted(trace.ranges)},
    }
    line = json.dumps(split)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
