"""Runtime observability for metrics_tpu_torch: spans, counters, exporters
(counterpart of ``metrics_tpu/obs``).

Quick start::

    import metrics_tpu_torch.obs as obs

    obs.enable()                  # or METRICS_TPU_OBS=1 in the environment
    ... run your eval loop ...
    print(obs.report())           # spans, counters, recent sync reports
    obs.dump_json("obs.json")
    print(obs.prometheus_text())  # scrape-ready exposition format

Counters (sync bytes/attempts, async rounds, checkpoint and streaming
events, fault injections) are always on: they only tick on cold paths.
Spans are sampled only while enabled; disabled, ``obs.span`` returns a
shared no-op and the hot update path pays a single flag check.  A span times
the host around a call and never synchronizes the device, so a span around
an update measures the host's launch time, not the kernels'.  While a
``torch.profiler`` session records, every enabled span also appears in the
profiler's trace as a user annotation of its name (``metric.forward``,
``metric.update_impl``, ``validation.check``, ``extractor.forward``, ...), on
the clock of the device operations launched inside it.  Counter names,
the exporters' text and ``METRICS_TPU_OBS`` are those of the JAX package, so
one environment switch and one scrape config serve both.
"""

from metrics_tpu_torch.obs.core import (
    NOOP_SPAN,
    counter_inc,
    counter_value,
    counters_snapshot,
    disable,
    enable,
    enabled,
    record_sync_report,
    reset,
    span,
    spans_snapshot,
    sync_reports,
)
from metrics_tpu_torch.obs.exporters import (
    dump_json,
    metric_values_prometheus_text,
    parse_prometheus_text,
    prometheus_text,
    report,
    summarize_counters,
)
from metrics_tpu_torch.obs.logging import warn_once

__all__ = [
    "NOOP_SPAN",
    "counter_inc",
    "counter_value",
    "counters_snapshot",
    "disable",
    "dump_json",
    "enable",
    "enabled",
    "metric_values_prometheus_text",
    "parse_prometheus_text",
    "prometheus_text",
    "record_sync_report",
    "report",
    "reset",
    "span",
    "spans_snapshot",
    "summarize_counters",
    "sync_reports",
    "warn_once",
]
