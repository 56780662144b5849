"""Autoscaler policy: turn serve-tier pressure signals into a target size
(counterpart of ``metrics_tpu/serve/autoscaler.py``).

Pure decision logic for the elastic fleet — this module OBSERVES and
RECOMMENDS, it never acts.  The caller (an operator loop, a drill, the
bench) feeds it :meth:`FleetCoordinator.ring_stats` snapshots plus a
counter snapshot, and asks :meth:`Autoscaler.recommend` for a target
shard count; actually applying it is ``coordinator.resize(target)`` (or
``LocalFleet.resize``), which this module deliberately cannot reach.

The two pressure signals, chosen because both are *leading* indicators
of the only degradation the fleet exhibits (whole-batch backpressure):

* **Staging-ring occupancy** — ``max(depth) / capacity`` across every
  per-(shard, job) ring.  Rings fill when forwarders cannot drain as
  fast as ingest stages; a full ring is the backpressure cliff.
* **Forwarder backoff** — the ``serve.forwarder_backoff_secs`` counter
  accumulates idle-wait only on *errored* drain passes, so its growth
  rate measures how much real time forwarders spend backing off from
  struggling workers.

Hysteresis gates both directions: a single hot poll (one burst filling
a ring) or one cold poll must not flap the fleet through a live
migration, so a grow or shrink is recommended only after ``hysteresis``
CONSECUTIVE agreeing observations — and never while a resize is already
in flight.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

__all__ = ["AutoscalerConfig", "FleetSignals", "Autoscaler", "autoscale_step"]

_BACKOFF_COUNTER = "serve.forwarder_backoff_secs"


@dataclass(frozen=True)
class AutoscalerConfig:
    """Thresholds and limits for the scaling policy.

    ``high_occupancy``/``grow_backoff_secs`` are OR'd for growth (either
    pressure signal alone justifies shards); shrink needs occupancy
    below ``low_occupancy`` AND no fresh backoff — scaling down under
    any pressure is never right.
    """

    min_shards: int = 1
    max_shards: int = 16
    high_occupancy: float = 0.50  # grow at/above this ring-fill fraction
    low_occupancy: float = 0.05  # shrink candidate below this fraction
    grow_backoff_secs: float = 0.5  # new backoff per observation forcing grow
    hysteresis: int = 3  # consecutive agreeing observations required
    step: int = 1  # shards added/removed per recommendation

    def __post_init__(self) -> None:
        if not 1 <= self.min_shards <= self.max_shards:
            raise MetricsTPUUserError(
                f"need 1 <= min_shards <= max_shards, got "
                f"[{self.min_shards}, {self.max_shards}]"
            )
        if not 0.0 <= self.low_occupancy < self.high_occupancy <= 1.0:
            raise MetricsTPUUserError(
                "need 0 <= low_occupancy < high_occupancy <= 1, got "
                f"[{self.low_occupancy}, {self.high_occupancy}]"
            )
        if self.hysteresis < 1 or self.step < 1:
            raise MetricsTPUUserError("hysteresis and step must be >= 1")


@dataclass(frozen=True)
class FleetSignals:
    """One observation of fleet pressure, normalized for the policy."""

    num_shards: int
    occupancy: float  # max ring depth / ring capacity, in [0, 1]
    backoff_secs: float  # cumulative forwarder backoff (monotone counter)
    resizing: bool = False

    @classmethod
    def from_stats(
        cls,
        stats: Mapping[str, Any],
        counters: Optional[Mapping[Any, float]] = None,
    ) -> "FleetSignals":
        """Build an observation from ``coordinator.ring_stats()`` plus an
        ``obs.core.counters_snapshot()`` (keys are ``(name, labels)``
        pairs; every shard label of the backoff counter is summed)."""
        capacity = max(1, int(stats.get("ring_capacity", 1)))
        depth = max(
            (int(ring.get("depth", 0)) for ring in stats.get("rings", ())),
            default=0,
        )
        backoff = 0.0
        if counters is not None:
            for key, value in counters.items():
                name = key[0] if isinstance(key, tuple) else key
                if name == _BACKOFF_COUNTER:
                    backoff += float(value)
        return cls(
            num_shards=int(stats.get("num_shards", 1)),
            occupancy=min(1.0, depth / capacity),
            backoff_secs=backoff,
            resizing=bool(stats.get("resizing", False)),
        )


class Autoscaler:
    """Hysteresis-gated grow/shrink policy over :class:`FleetSignals`.

    Feed every poll to :meth:`observe`; :meth:`recommend` returns the
    target shard count (== current size when no change is warranted).
    The backoff counter is monotone, so pressure is its DELTA between
    consecutive observations, not its absolute value.
    """

    def __init__(self, config: Optional[AutoscalerConfig] = None) -> None:
        self.config = config or AutoscalerConfig()
        self._last: Optional[FleetSignals] = None
        self._hot = 0  # consecutive observations wanting growth
        self._cold = 0  # consecutive observations allowing shrink

    # ---------------------------------------------------------------- policy
    def observe(self, signals: FleetSignals) -> None:
        cfg = self.config
        backoff_delta = signals.backoff_secs
        if self._last is not None:
            backoff_delta = max(
                0.0, signals.backoff_secs - self._last.backoff_secs
            )
        self._last = signals
        if signals.resizing:
            # mid-migration pressure is self-inflicted (held jobs park
            # rows); it must not feed the streaks in either direction
            return
        hot = (
            signals.occupancy >= cfg.high_occupancy
            or backoff_delta >= cfg.grow_backoff_secs
        )
        cold = signals.occupancy <= cfg.low_occupancy and backoff_delta == 0.0
        self._hot = self._hot + 1 if hot else 0
        self._cold = self._cold + 1 if cold else 0

    def recommend(self) -> int:
        """Target shard count given the observation streaks; resets the
        winning streak when it fires (the resize it triggers invalidates
        every older observation)."""
        cfg = self.config
        if self._last is None:
            return cfg.min_shards
        current = self._last.num_shards
        if self._hot >= cfg.hysteresis:
            target = min(cfg.max_shards, current + cfg.step)
            if target != current:
                self._hot = 0
                self._cold = 0
                return target
        if self._cold >= cfg.hysteresis:
            target = max(cfg.min_shards, current - cfg.step)
            if target != current:
                self._hot = 0
                self._cold = 0
                return target
        return current

    def state(self) -> Dict[str, Any]:
        """Introspection for drills and the bench report."""
        return {
            "hot_streak": self._hot,
            "cold_streak": self._cold,
            "last_occupancy": (
                None if self._last is None else round(self._last.occupancy, 6)
            ),
            "last_backoff_secs": (
                None if self._last is None else round(self._last.backoff_secs, 6)
            ),
        }


def autoscale_step(
    autoscaler: Autoscaler,
    stats: Mapping[str, Any],
    counters: Optional[Mapping[Any, float]] = None,
) -> Tuple[int, FleetSignals]:
    """One observe → recommend turn; returns ``(target, signals)``.

    Convenience for operator loops::

        target, _ = autoscale_step(scaler, coord.ring_stats(), counters)
        if target != coord.num_shards:
            fleet.resize(target)
    """
    signals = FleetSignals.from_stats(stats, counters)
    autoscaler.observe(signals)
    return autoscaler.recommend(), signals
