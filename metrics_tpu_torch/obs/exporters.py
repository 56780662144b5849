"""Exporters: structured report, JSON dump, and Prometheus text format
(counterpart of ``metrics_tpu/obs/exporters.py``; for the same counters and
spans the text is byte for byte the JAX package's).

The Prometheus renderer follows the text exposition format (one
``name{labels} value`` line per series, ``# TYPE`` headers, counter series
suffixed ``_total``). ``parse_prometheus_text`` is the matching line parser
used by tests to round-trip the output.
"""

import json
import math
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

from metrics_tpu_torch.obs.core import (
    CounterKey,
    _rt,
    counters_snapshot,
    spans_snapshot,
    sync_reports,
)

_PROM_PREFIX = "metrics_tpu_"
_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def report() -> Dict[str, Any]:
    """Everything the runtime knows, as plain JSON-serializable data."""
    counters = [
        {"name": name, "labels": dict(labels), "value": value}
        for (name, labels), value in sorted(counters_snapshot().items())
    ]
    spans = [
        {
            "name": name,
            "labels": dict(labels),
            "count": int(agg[0]),
            "total_secs": round(agg[1], 6),
            "max_secs": round(agg[2], 6),
        }
        for (name, labels), agg in sorted(spans_snapshot().items())
    ]
    with _rt.lock:
        events = list(_rt.events)
    return {
        "enabled": _rt.enabled,
        "counters": counters,
        "spans": spans,
        "sync_reports": sync_reports(),
        "recent_events": events,
    }


def dump_json(path: str, indent: int = 2) -> str:
    """Write ``report()`` to ``path``; returns the path for chaining."""
    with open(path, "w") as fh:
        json.dump(report(), fh, indent=indent, sort_keys=True, default=str)
        fh.write("\n")
    return path


# ---------------------------------------------------------------------------
# Prometheus text format


def _prom_name(name: str) -> str:
    return _PROM_PREFIX + _NAME_RE.sub("_", name)


def _prom_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    parts = []
    for key, value in labels:
        escaped = value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
        parts.append(f'{_NAME_RE.sub("_", key)}="{escaped}"')
    return "{" + ",".join(parts) + "}"


def _fmt(value: float) -> str:
    if isinstance(value, float) and not value.is_integer():
        return repr(round(value, 9))
    return str(int(value))


def prometheus_text() -> str:
    """Render counters and span aggregates in Prometheus exposition format."""
    lines: List[str] = []

    by_name: Dict[str, List[Tuple[CounterKey, float]]] = {}
    for key, value in sorted(counters_snapshot().items()):
        by_name.setdefault(key[0], []).append((key, value))
    for name, series in by_name.items():
        prom = _prom_name(name) + "_total"
        lines.append(f"# TYPE {prom} counter")
        for (_, labels), value in series:
            lines.append(f"{prom}{_prom_labels(labels)} {_fmt(value)}")

    spans = sorted(spans_snapshot().items())
    if spans:
        for suffix, idx, kind in (
            ("span_count_total", 0, "counter"),
            ("span_seconds_total", 1, "counter"),
            ("span_seconds_max", 2, "gauge"),
        ):
            prom = _PROM_PREFIX + suffix
            lines.append(f"# TYPE {prom} {kind}")
            for (name, labels), agg in spans:
                full = (("span", name),) + labels
                lines.append(f"{prom}{_prom_labels(full)} {_fmt(agg[idx])}")

    return "\n".join(lines) + "\n" if lines else ""


_METRIC_VALUE_GAUGE = _PROM_PREFIX + "metric_value"


def _gauge_fmt(value: float) -> str:
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    return _fmt(value)


def metric_values_prometheus_text(values: Any) -> str:
    """Render *computed metric values* as labeled gauges.

    The counters/spans in :func:`prometheus_text` describe the runtime; this
    exporter describes the evaluation results themselves, as one gauge family
    ``metrics_tpu_metric_value{job="..."}`` — the scrape surface the serve
    layer's ``/metrics`` endpoint adds on top of the counters.

    ``values`` is either a mapping ``job -> value`` or any object with an
    ``export_values()`` method returning one (duck-typed so
    a serving registry plugs in without obs importing it).
    Each value may be:

    * a scalar (anything ``float()`` accepts) — one series per job;
    * a mapping ``component -> scalar`` — one series per component, labeled
      ``component="..."`` (dict-computing metrics, named vector components);
    * an iterable of ``(labels_dict, scalar)`` pairs — arbitrary extra labels
      (the registry uses this for per-stream ``top_k`` exports).

    NaN-safe: non-finite values render as Prometheus' literal ``NaN`` /
    ``+Inf`` / ``-Inf`` instead of crashing the scrape, and
    :func:`parse_prometheus_text` round-trips them.
    """
    if not isinstance(values, Mapping) and hasattr(values, "export_values"):
        values = values.export_values()
    series: List[Tuple[Tuple[Tuple[str, str], ...], float]] = []
    for job in sorted(values):
        value = values[job]
        base = (("job", str(job)),)
        if isinstance(value, Mapping):
            for comp in sorted(value):
                series.append((base + (("component", str(comp)),), float(value[comp])))
        elif isinstance(value, (list, tuple)):
            for labels, v in value:
                extra = tuple(sorted((str(k), str(lv)) for k, lv in dict(labels).items()))
                series.append((base + extra, float(v)))
        else:
            series.append((base, float(value)))
    if not series:
        return ""
    lines = [f"# TYPE {_METRIC_VALUE_GAUGE} gauge"]
    for labels, v in series:
        lines.append(f"{_METRIC_VALUE_GAUGE}{_prom_labels(labels)} {_gauge_fmt(v)}")
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float]:
    """Parse exposition-format lines back into {(name, labels): value}.

    Understands the subset ``prometheus_text`` emits (no timestamps, no
    exemplars) plus escaped label values; raises ValueError on malformed
    lines so tests catch renderer drift.
    """
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if "{" in line:
            name, rest = line.split("{", 1)
            labels_src, _, value_src = rest.rpartition("} ")
            if not _:
                raise ValueError(f"malformed series line: {raw!r}")
            labels = _parse_labels(labels_src)
        else:
            name, _, value_src = line.rpartition(" ")
            labels = ()
        if not name or not value_src:
            raise ValueError(f"malformed series line: {raw!r}")
        out[(name, labels)] = float(value_src)
    return out


def _parse_labels(src: str) -> Tuple[Tuple[str, str], ...]:
    labels: List[Tuple[str, str]] = []
    i, n = 0, len(src)
    while i < n:
        eq = src.index("=", i)
        key = src[i:eq]
        if src[eq + 1] != '"':
            raise ValueError(f"unquoted label value near {src[i:]!r}")
        j = eq + 2
        buf: List[str] = []
        while j < n:
            ch = src[j]
            if ch == "\\":
                nxt = src[j + 1]
                buf.append({"n": "\n", '"': '"', "\\": "\\"}.get(nxt, nxt))
                j += 2
                continue
            if ch == '"':
                break
            buf.append(ch)
            j += 1
        else:
            raise ValueError(f"unterminated label value near {src[i:]!r}")
        labels.append((key, "".join(buf)))
        i = j + 1
        if i < n and src[i] == ",":
            i += 1
    return tuple(labels)


# ---------------------------------------------------------------------------
# compact summaries (benchmark attribution sections)


def summarize_counters(
    counters: Optional[Dict[CounterKey, float]] = None,
) -> Dict[str, Any]:
    """Fold raw counters into the compact attribution dict a benchmark embeds.

    Accepts a snapshot (or a delta of two snapshots) from
    ``counters_snapshot``; zero-valued sections are omitted so quiet configs
    stay quiet in the output.
    """
    if counters is None:
        counters = counters_snapshot()
    recompiles = 0.0
    by_metric: Dict[str, float] = {}
    sync: Dict[str, float] = {}
    streaming: Dict[str, float] = {}
    multistream: Dict[str, float] = {}
    ckpt: Dict[str, float] = {}
    serve: Dict[str, float] = {}
    iou_hits = iou_misses = 0.0
    fallbacks = 0.0
    faults = 0.0
    suppressed = 0.0
    for (name, labels), value in counters.items():
        if not value:
            continue
        if name == "jit_traces":
            recompiles += value
            metric = dict(labels).get("metric", "?")
            by_metric[metric] = by_metric.get(metric, 0) + value
        elif name.startswith("sync."):
            field = name[len("sync."):]
            sync[field] = sync.get(field, 0) + value
        elif name.startswith("streaming."):
            field = name[len("streaming."):]
            streaming[field] = streaming.get(field, 0) + value
        elif name.startswith("multistream."):
            field = name[len("multistream."):]
            multistream[field] = multistream.get(field, 0) + value
        elif name.startswith("ckpt."):
            field = name[len("ckpt."):]
            ckpt[field] = ckpt.get(field, 0) + value
        elif name.startswith("serve."):
            field = name[len("serve."):]
            serve[field] = serve.get(field, 0) + value
        elif name == "iou_cache.hits":
            iou_hits += value
        elif name == "iou_cache.misses":
            iou_misses += value
        elif name == "eager_fallback":
            fallbacks += value
        elif name == "chaos.faults":
            faults += value
        elif name == "warn_once.suppressed":
            suppressed += value
    out: Dict[str, Any] = {}
    if recompiles:
        out["recompiles"] = int(recompiles)
        out["recompiles_by_metric"] = {k: int(v) for k, v in sorted(by_metric.items())}
    if sync:
        out["sync"] = {
            k: (round(v, 6) if k in ("backoff_secs", "overlap_secs") else int(v))
            for k, v in sorted(sync.items())
        }
    if streaming:
        out["streaming"] = {k: int(v) for k, v in sorted(streaming.items())}
    if multistream:
        out["multistream"] = {k: int(v) for k, v in sorted(multistream.items())}
    if ckpt:
        out["ckpt"] = {k: int(v) for k, v in sorted(ckpt.items())}
    if serve:
        # forwarder backoff is wall-clock seconds, the one float in the
        # serve bucket (same treatment as sync's backoff_secs above)
        out["serve"] = {
            k: (round(v, 6) if k == "forwarder_backoff_secs" else int(v))
            for k, v in sorted(serve.items())
        }
    if iou_hits or iou_misses:
        out["iou_cache"] = {
            "hits": int(iou_hits),
            "misses": int(iou_misses),
            "hit_rate": round(iou_hits / (iou_hits + iou_misses), 4),
        }
    if fallbacks:
        out["eager_fallbacks"] = int(fallbacks)
    if faults:
        out["chaos_faults"] = int(faults)
    if suppressed:
        out["warnings_suppressed"] = int(suppressed)
    return out
