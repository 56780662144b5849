"""Runtime telemetry core: spans, counters, and the sync-report registry
(counterpart of ``metrics_tpu/obs/core.py``).

Two cost tiers, chosen per instrument:

* **Counters are always on.** Every counter site lives on a cold path —
  cross-process sync, checkpoint I/O, fault injection, a state read or a
  query — so the bookkeeping is free relative to the work it annotates, and
  no counter reads the device where the work it annotates does not already.
* **Spans are gated.** ``span()`` checks a module-level flag and returns a
  shared no-op singleton when disabled; hot methods (``Metric.update``) are
  wrapped by :func:`spanned`, whose disabled path costs one attribute load
  and a branch.

Spans time the host with ``time.perf_counter`` and never synchronize the
device: a span around a CUDA update measures the launches, not the kernels.
While a ``torch.profiler`` session records, an enabled span also opens a
profiler user annotation of its name, so the profiler's trace puts the
span on the same clock as the device operations launched inside it.
Everything here is process-local and thread-safe and imports nothing of the
package (``torch`` only on the first enabled span), so any layer may pull
it in.
"""

import functools
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

_EVENT_RING = 256
_SYNC_RING = 64

LabelsKey = Tuple[Tuple[str, str], ...]
CounterKey = Tuple[str, LabelsKey]


class _Runtime:
    """Singleton holding all telemetry state behind one lock."""

    __slots__ = ("enabled", "lock", "counters", "spans", "events", "sync_reports", "tls")

    def __init__(self) -> None:
        self.enabled = False
        self.lock = threading.Lock()
        # (name, labels) -> float
        self.counters: Dict[CounterKey, float] = {}
        # (name, labels) -> [count, total_secs, max_secs]
        self.spans: Dict[CounterKey, List[float]] = {}
        self.events: deque = deque(maxlen=_EVENT_RING)
        self.sync_reports: deque = deque(maxlen=_SYNC_RING)
        self.tls = threading.local()


_rt = _Runtime()

# Callables run by reset() so satellite stores (e.g. the warn-once registry)
# clear together with the core state without core importing them.
_reset_hooks: List[Callable[[], None]] = []


def _labels_key(labels: Dict[str, Any]) -> LabelsKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


# ---------------------------------------------------------------------------
# enable / disable


def enable() -> None:
    """Turn span tracing on (counters are always on)."""
    _rt.enabled = True


def disable() -> None:
    _rt.enabled = False


def enabled() -> bool:
    return _rt.enabled


def reset() -> None:
    """Clear all counters, spans, events, sync reports, and hook stores."""
    with _rt.lock:
        _rt.counters.clear()
        _rt.spans.clear()
        _rt.events.clear()
        _rt.sync_reports.clear()
    for hook in _reset_hooks:
        hook()


# ---------------------------------------------------------------------------
# counters (always on)


def counter_inc(name: str, value: float = 1, **labels: Any) -> None:
    key = (name, _labels_key(labels))
    with _rt.lock:
        _rt.counters[key] = _rt.counters.get(key, 0) + value


def counter_value(name: str, **labels: Any) -> float:
    key = (name, _labels_key(labels))
    with _rt.lock:
        return _rt.counters.get(key, 0)


def counters_snapshot() -> Dict[CounterKey, float]:
    """Point-in-time copy of every counter; keys are (name, labels) pairs."""
    with _rt.lock:
        return dict(_rt.counters)


# ---------------------------------------------------------------------------
# spans


class _NoopSpan:
    """Shared do-nothing span returned whenever tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **labels: Any) -> "_NoopSpan":
        return self


NOOP_SPAN = _NoopSpan()


# torch's "is a profiler recording" check and its user annotation, bound by
# the first enabled span
_profiler: Optional[Tuple[Callable[[], bool], Callable[[str], Any]]] = None


def _annotation(name: str) -> Any:
    """An entered profiler user annotation named ``name`` while a profiler
    records, else ``None``."""
    global _profiler
    if _profiler is None:
        import torch

        _profiler = (torch._C._autograd._profiler_enabled, torch.profiler.record_function)
    recording, record_function = _profiler
    if not recording():
        return None
    annotation = record_function(name)
    annotation.__enter__()
    return annotation


class _Span:
    __slots__ = ("name", "labels", "_start", "_parent", "_annotation")

    def __init__(self, name: str, labels: Dict[str, Any]) -> None:
        self.name = name
        self.labels = labels

    def set(self, **labels: Any) -> "_Span":
        self.labels.update(labels)
        return self

    def __enter__(self) -> "_Span":
        stack = getattr(_rt.tls, "stack", None)
        if stack is None:
            stack = _rt.tls.stack = []
        self._parent = stack[-1].name if stack else None
        stack.append(self)
        self._annotation = _annotation(self.name)
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> bool:
        dur = time.perf_counter() - self._start
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        stack = getattr(_rt.tls, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        labels = self.labels
        if self._parent is not None:
            labels = dict(labels)
            labels["parent"] = self._parent
        key = (self.name, _labels_key(labels))
        with _rt.lock:
            agg = _rt.spans.get(key)
            if agg is None:
                agg = _rt.spans[key] = [0, 0.0, 0.0]
            agg[0] += 1
            agg[1] += dur
            if dur > agg[2]:
                agg[2] = dur
            _rt.events.append({"span": self.name, "labels": dict(labels), "secs": dur})
        return False


def span(name: str, **labels: Any) -> Any:
    """Context manager timing a region; returns a shared no-op when disabled.

    Nesting is tracked per thread: a span entered inside another records a
    ``parent`` label with the enclosing span's name, which is how
    ``MetricCollection`` attributes member time to the collection call.
    """
    if not _rt.enabled:
        return NOOP_SPAN
    return _Span(name, labels)


def spanned(name: str, labels: Callable[[Any], Dict[str, Any]]) -> Callable[[Callable], Callable]:
    """Method decorator: run the method inside ``span(name, **labels(self))``
    while tracing is enabled, and straight through, after one flag check,
    while it is disabled."""

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def inner(self: Any, *args: Any, **kwargs: Any) -> Any:
            if not _rt.enabled:
                return fn(self, *args, **kwargs)
            with _Span(name, labels(self)):
                return fn(self, *args, **kwargs)

        return inner

    return wrap


def spanned_function(name: str) -> Callable[[Callable], Callable]:
    """Function decorator: :func:`spanned` for a plain function, with no
    labels."""

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def inner(*args: Any, **kwargs: Any) -> Any:
            if not _rt.enabled:
                return fn(*args, **kwargs)
            with _Span(name, {}):
                return fn(*args, **kwargs)

        return inner

    return wrap


def spans_snapshot() -> Dict[CounterKey, List[float]]:
    """Copy of span aggregates: (name, labels) -> [count, total_secs, max_secs]."""
    with _rt.lock:
        return {k: list(v) for k, v in _rt.spans.items()}


# ---------------------------------------------------------------------------
# sync-report registry (absorbs Metric.last_sync_report; always on)

_SYNC_COUNTER_KEYS = (
    "bytes_gathered",
    "gather_calls",
    "retries",
    "attempts",
    "bytes_saved",
    # preflight metadata traffic is accounted apart from state payload so
    # `bytes_gathered` means the same thing on every eager backend
    "preflight_bytes",
    "preflight_calls",
    # the mesh backend's in-program path has no wire bytes to count
    "in_xla_reductions",
)


def record_sync_report(metric: str, report: Dict[str, Any]) -> None:
    """File one per-sync telemetry dict into the queryable registry.

    Fed by ``Metric._finish_sync_report`` after every distributed sync
    attempt (success or failure); also rolls the headline figures into the
    ``sync.*`` counters so exporters see process totals without walking the
    ring.
    """
    entry = {"metric": metric}
    entry.update(report)
    with _rt.lock:
        _rt.sync_reports.append(entry)
    counter_inc("sync.reports", metric=metric)
    if report.get("error"):
        counter_inc("sync.errors", metric=metric)
    if "delta" in report:
        # the delta/full split only exists for gathers that actually ran; the
        # single source is the report so per-metric and process totals agree
        counter_inc("sync.delta_syncs" if report["delta"] else "sync.full_syncs", metric=metric)
    for key in _SYNC_COUNTER_KEYS:
        val = report.get(key) or 0
        if val:
            counter_inc("sync." + key, int(val), metric=metric)
    backoff = report.get("backoff_secs") or 0.0
    if backoff:
        counter_inc("sync.backoff_secs", float(backoff), metric=metric)
    overlap = report.get("overlap_secs") or 0.0
    if overlap:
        counter_inc("sync.overlap_secs", float(overlap), metric=metric)


def sync_reports(metric: Optional[str] = None) -> List[Dict[str, Any]]:
    """Recent sync reports (newest last), optionally filtered by metric name."""
    with _rt.lock:
        out = list(_rt.sync_reports)
    if metric is not None:
        out = [r for r in out if r.get("metric") == metric]
    return out


# ---------------------------------------------------------------------------

if os.environ.get("METRICS_TPU_OBS", "").strip().lower() in ("1", "true", "yes", "on"):
    enable()
