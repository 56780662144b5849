"""Deterministic traffic for soak tests and the serve bench (counterpart of
``metrics_tpu/serve/traffic.py``: the same records for the same seed).

A :class:`TrafficGenerator` is a pure function of ``(seed, index)``: record
``i`` is the same bytes every run and every process, so a kill→restore drill
can replay "records ``k`` onward" after recovering a checkpoint that covered
"records ``0..k``" and compare final state bit-for-bit against an
uninterrupted run of the same schedule.

Records round-robin across the registry's jobs (index → job); multistream
rows cycle through a tenant id pattern with a deliberate out-of-range id
mixed in so the drop lane stays exercised.
"""

from __future__ import annotations

from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from metrics_tpu_torch.serve.ingest import Record
from metrics_tpu_torch.serve.registry import MetricRegistry
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

__all__ = ["JobTraffic", "TrafficGenerator"]


class JobTraffic:
    """Per-job record recipe.

    ``arity`` positional values per record; ``num_streams`` routes records
    over ``[0, num_streams)`` tenant ids when set (with every
    ``oob_every``-th record aimed at an out-of-range id to exercise the
    drop path); values are drawn from a counter-keyed Philox stream so the
    i-th record never depends on how many were drawn before it.
    """

    def __init__(
        self,
        job: str,
        arity: int = 2,
        num_streams: Optional[int] = None,
        oob_every: int = 0,
        integer_values: bool = False,
    ) -> None:
        self.job = job
        self.arity = int(arity)
        self.num_streams = num_streams
        self.oob_every = int(oob_every)
        self.integer_values = bool(integer_values)

    def record(self, seed: int, index: int) -> Record:
        # counter-based: one fresh Philox stream per (seed, index); O(1)
        # random access is what lets the drill replay from any offset
        rng = np.random.Generator(np.random.Philox(key=seed, counter=[0, 0, 0, index]))
        if self.integer_values:
            values: Tuple[Any, ...] = tuple(
                np.int32(rng.integers(0, 10)) for _ in range(self.arity)
            )
        else:
            values = tuple(np.float32(rng.uniform(0.0, 1.0)) for _ in range(self.arity))
        stream_id: Optional[int] = None
        if self.num_streams is not None:
            if self.oob_every and index % self.oob_every == self.oob_every - 1:
                stream_id = self.num_streams + 7  # dropped on device, by design
            else:
                stream_id = int(rng.integers(0, self.num_streams))
        return Record(self.job, values, stream_id)


class TrafficGenerator:
    """Addressable record schedule over several jobs.

    ``record(i)`` is deterministic in ``(seed, i)`` alone.  ``replay(lo,
    hi)`` yields records ``lo..hi-1`` — the uninterrupted run uses
    ``replay(0, n)``, the drill's second half uses ``replay(k, n)``.
    """

    def __init__(self, jobs: Sequence[JobTraffic], seed: int = 0) -> None:
        if not jobs:
            raise MetricsTPUUserError("TrafficGenerator needs at least one JobTraffic")
        self.jobs = list(jobs)
        self.seed = int(seed)

    def record(self, index: int) -> Record:
        spec = self.jobs[index % len(self.jobs)]
        # mix the job slot into the per-record seed so two jobs never see
        # identical value streams
        return spec.record(self.seed * 1_000_003 + (index % len(self.jobs)), index)

    def replay(self, lo: int, hi: int) -> Iterator[Record]:
        for i in range(lo, hi):
            yield self.record(i)

    def records(self, n: int) -> List[Record]:
        return [self.record(i) for i in range(n)]


def default_traffic(registry: MetricRegistry, seed: int = 0) -> TrafficGenerator:
    """A TrafficGenerator matching a registry's jobs: multistream jobs get
    routed ids (with an out-of-range id every 13th record), others plain
    rows; arity follows each job's registered metric where discoverable
    (falls back to 2 positional values)."""
    specs = []
    for job in registry.jobs():
        if job.is_multistream:
            specs.append(
                JobTraffic(
                    job.name,
                    arity=2,
                    num_streams=job.metric.num_streams,
                    oob_every=13,
                )
            )
        else:
            specs.append(JobTraffic(job.name, arity=2))
    return TrafficGenerator(specs, seed=seed)


__all__.append("default_traffic")
