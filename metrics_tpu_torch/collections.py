"""MetricCollection with compute groups (counterpart of ``metrics_tpu/collections.py``).

Compute groups: metrics whose states are identical after the first update
(e.g. Precision/Recall/F1 on the same tp/fp/tn/fn) are detected
automatically; afterwards ``update`` runs ONCE per group and the other
members point at the leader's state tensors.  States are rebound, never
written in place, so the shared tensors stay valid until the next update
re-points the members.  Buffer states are appended in place, but only by
the leader, past the rows the members see: a member copies a shared buffer
before it appends to it.
"""

from copy import deepcopy
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from metrics_tpu_torch.metric import Metric, _resolve_device
from metrics_tpu_torch.obs import core as _obs
from metrics_tpu_torch.utils.data import _flatten_dict, allclose


def _collection_labels(collection: "MetricCollection") -> Dict[str, Any]:
    return {"members": len(collection._modules)}


class MetricCollection(nn.Module):
    """Dict-of-metrics sharing one call interface.

    Args:
        metrics: a Metric, a sequence of Metrics, or a dict name -> Metric.
        prefix / postfix: added to every key in the output dict.
        compute_groups: auto-detect metrics with identical states and update
            only one representative per group (True by default), or an explicit
            list of name-groups.
        device: the device every member keeps its state on, ``"cuda"`` (the
            default) or ``"cpu"``; a member on another device raises.
        on_sync_error / sync_timeout / sync_max_retries / sync_backoff /
            validate_sync: sync policy set on EVERY member at registration
            (see the :class:`~metrics_tpu_torch.Metric` kwargs of the same
            names); ``None`` leaves each member's own setting.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy, MetricCollection, Precision
        >>> target = torch.tensor([0, 2, 0, 2, 0, 1, 0, 2])
        >>> preds = torch.tensor([2, 1, 2, 0, 1, 2, 2, 2])
        >>> metrics = MetricCollection(
        ...     {'acc': Accuracy(num_classes=3, device='cpu'),
        ...      'prec': Precision(num_classes=3, average='macro', device='cpu')},
        ...     device='cpu')
        >>> metrics.update(preds, target)
        >>> sorted(metrics.compute())
        ['acc', 'prec']
    """

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        compute_groups: Union[bool, List[List[str]]] = True,
        device: str = "cuda",
        on_sync_error: Optional[str] = None,
        sync_timeout: Optional[float] = None,
        sync_max_retries: Optional[int] = None,
        sync_backoff: Optional[float] = None,
        validate_sync: Optional[bool] = None,
    ) -> None:
        super().__init__()
        self.device = _resolve_device(device)
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")
        if on_sync_error is not None and on_sync_error not in ("raise", "local", "skip"):
            raise ValueError(f"`on_sync_error` must be 'raise', 'local' or 'skip', got {on_sync_error!r}")
        self._sync_policy = {
            "on_sync_error": on_sync_error,
            "sync_timeout": sync_timeout,
            "sync_max_retries": sync_max_retries,
            "sync_backoff": sync_backoff,
            "validate_sync": validate_sync,
        }
        self._enable_compute_groups = compute_groups
        self._groups_checked = False
        self._compute_groups: Dict[int, List[str]] = {}
        self.add_metrics(metrics, *additional_metrics)

    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(f"Expected input `{name}` to be a string, but got {type(arg)}")

    # ------------------------------------------------------------- population
    def _register(self, name: str, metric: Metric) -> None:
        if name in self._modules:
            raise ValueError(
                f"Metric name {name!r} occurs twice; use distinct mapping keys"
                " to disambiguate instances of one class"
            )
        if metric.device != self.device:
            raise ValueError(
                f"Metric {name!r} keeps its state on {metric.device}, but the collection is on {self.device}"
            )
        for key, value in self._sync_policy.items():
            if value is not None:
                setattr(metric, key, value)
        self.add_module(name, metric)

    def add_metrics(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        *additional_metrics: Metric,
    ) -> None:
        """Register metrics: a single Metric, a sequence of Metrics/MetricCollections
        (named by class; duplicates rejected), or a mapping name -> Metric
        (nested collections flattened as ``<name>_<member>``)."""
        if isinstance(metrics, Metric):
            metrics = [metrics]
        if isinstance(metrics, dict):
            if additional_metrics:
                raise ValueError(
                    "Positional metrics cannot be mixed with a mapping input; got "
                    f"{len(additional_metrics)} extra positional argument(s): {additional_metrics}"
                )
            for name in sorted(metrics):
                entry = metrics[name]
                if isinstance(entry, Metric):
                    self._register(name, entry)
                elif isinstance(entry, MetricCollection):
                    for sub_name, sub_metric in entry.items(keep_base=False):
                        self._register(f"{name}_{sub_name}", sub_metric)
                else:
                    raise ValueError(
                        f"Mapping value under key {name!r} must be a Metric or MetricCollection,"
                        f" got {type(entry).__name__}: {entry!r}"
                    )
        elif isinstance(metrics, Sequence):
            entries = (*metrics, *additional_metrics)
            rejected = [e for e in entries if not isinstance(e, (Metric, MetricCollection))]
            if rejected:
                raise ValueError(
                    "Every positional input to MetricCollection must be a Metric or"
                    f" MetricCollection; rejected: {rejected}"
                )
            for entry in entries:
                pairs = (
                    [(type(entry).__name__, entry)]
                    if isinstance(entry, Metric)
                    else list(entry.items(keep_base=False))
                )
                for name, sub_metric in pairs:
                    self._register(name, sub_metric)
        else:
            raise ValueError(
                f"Cannot build a MetricCollection from {type(metrics).__name__}; expected a"
                " Metric, a sequence of Metrics, or a mapping name -> Metric"
            )

        if isinstance(self._enable_compute_groups, list):
            # explicit groups: validate names, skip auto-detection entirely
            self._compute_groups = {i: list(g) for i, g in enumerate(self._enable_compute_groups)}
            for group in self._compute_groups.values():
                for name in group:
                    if name not in self._modules:
                        raise ValueError(
                            f"Input {name} in `compute_groups` argument does not match a metric in the collection"
                        )
            # metrics not named in any explicit group become singleton groups
            grouped = {name for g in self._compute_groups.values() for name in g}
            next_idx = len(self._compute_groups)
            for name in self._modules:
                if name not in grouped:
                    self._compute_groups[next_idx] = [name]
                    next_idx += 1
            self._groups_checked = True
        else:
            self._compute_groups = {}
            self._groups_checked = False

    # ------------------------------------------------------------------ calls
    @_obs.spanned("collection.forward", _collection_labels)
    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Per-metric forward; returns {name: batch value}."""
        res = {k: m(*args, **m._filter_kwargs(**kwargs)) for k, m in self._modules.items()}
        # forward ran full updates on every metric; group states are in sync
        # again only after re-sharing
        if self._groups_checked:
            self._share_group_states()
        return {self._to_key(k): v for k, v in res.items()}

    @_obs.spanned("collection.update", _collection_labels)
    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update once per compute group."""
        self._update_via("update", *args, **kwargs)

    @_obs.spanned("collection.update_batched", _collection_labels)
    def update_batched(self, *args: Any, **kwargs: Any) -> None:
        """Fold a stack of batches (leading ``n_batches`` axis) once per compute group."""
        self._update_via("update_batched", *args, **kwargs)

    def _update_via(self, method_name: str, *args: Any, **kwargs: Any) -> None:
        if self._groups_checked:
            for group in self._compute_groups.values():
                leader = self._modules[group[0]]
                getattr(leader, method_name)(*args, **leader._filter_kwargs(**kwargs))
            self._share_group_states()
        else:
            for m in self._modules.values():
                getattr(m, method_name)(*args, **m._filter_kwargs(**kwargs))
            if self._enable_compute_groups:
                self._merge_compute_groups()
                self._groups_checked = True

    def _merge_compute_groups(self) -> None:
        """Group metrics whose post-first-update states are identical: each
        metric joins the first group whose leader holds equal states, else
        founds its own group."""
        groups: List[List[str]] = []
        for name, metric in self._modules.items():
            target = next(
                (g for g in groups if self._equal_metric_states(self._modules[g[0]], metric)),
                None,
            )
            if target is None:
                groups.append([name])
            else:
                target.append(name)
        self._compute_groups = dict(enumerate(groups))
        self._share_group_states()

    @staticmethod
    def _equal_metric_states(metric1: Metric, metric2: Metric) -> bool:
        """Same state names, shapes and (allclose) values."""
        if not metric1._defaults or not metric2._defaults:
            return False
        if metric1._defaults.keys() != metric2._defaults.keys():
            return False
        for key in metric1._defaults:
            s1, s2 = getattr(metric1, key), getattr(metric2, key)
            if type(s1) != type(s2):  # noqa: E721
                return False
            if isinstance(s1, list):
                if len(s1) != len(s2) or not all(allclose(a, b) for a, b in zip(s1, s2)):
                    return False
            elif isinstance(s1, int):  # a buffer's row count
                if s1 != s2:
                    return False
            elif not allclose(s1, s2):
                return False
        return True

    def _share_group_states(self) -> None:
        """Point every member at its leader's state tensors."""
        for group in self._compute_groups.values():
            leader = self._modules[group[0]]
            for name in group[1:]:
                member = self._modules[name]
                if leader._host_buffers_dirty:
                    # the leader's host sums wait for a read: so does the member's copy of them
                    member._follow_leader(leader)
                else:
                    for key in member._defaults:
                        value = getattr(leader, key)
                        # lists are appended to in place: each member gets its own list
                        setattr(member, key, list(value) if isinstance(value, list) else value)
                    for bname, meta in member._buffer_states.items():
                        # the leader alone appends in place into the shared buffers
                        member._refresh_buffer_meta(bname)
                        meta["owned"] = None
                member._update_count = leader._update_count
                member._computed = None
                # shared states share ONE synced watermark: a member syncing
                # through its own cache would splice the leader's prefix at
                # the wrong row
                member._delta_cache = leader._delta_cache

    def advance_windows(self) -> Dict[str, int]:
        """Rotate every :class:`~metrics_tpu_torch.streaming.WindowedMetric`
        member to its next bucket.

        Compute-group members alias their leader's states, so only group
        leaders advance (advancing an aliased member as well would skip a
        bucket); the leaders' new states are then shared again.  Returns
        ``{member_name: evicted_update_count}`` for the windows advanced.
        """
        from metrics_tpu_torch.streaming.window import WindowedMetric

        evicted: Dict[str, int] = {}
        if self._groups_checked and self._compute_groups:
            for group in self._compute_groups.values():
                leader = self._modules[group[0]]
                if isinstance(leader, WindowedMetric):
                    evicted[group[0]] = leader.advance()
            self._share_group_states()
        else:
            for name, m in self._modules.items():
                if isinstance(m, WindowedMetric):
                    evicted[name] = m.advance()
        return evicted

    def sync_async(self, backend: Optional[Any] = None) -> Dict[str, Any]:
        """Start one background sync round per member (per compute-group
        leader once groups are formed: the members alias the leader's states
        and delta cache, so one round covers the group).

        Returns ``{member_name: AsyncSyncHandle | None}``; ``None`` means the
        member started nothing (see :meth:`Metric.sync_async`).  Each member's
        next ``sync``/``compute`` folds its round in.
        """
        handles: Dict[str, Any] = {}
        if self._groups_checked and self._compute_groups:
            for group in self._compute_groups.values():
                handles[group[0]] = self._modules[group[0]].sync_async(backend=backend)
        else:
            for name, m in self._modules.items():
                handles[name] = m.sync_async(backend=backend)
        return handles

    # member metric.compute spans nest under this one, which gives
    # per-member time attribution for the collection call
    @_obs.spanned("collection.compute", _collection_labels)
    def compute(self) -> Dict[str, Any]:
        res = _flatten_dict({k: m.compute() for k, m in self._modules.items()})
        return {self._to_key(k): v for k, v in res.items()}

    def set_dtype(self, dst_type: torch.dtype) -> "MetricCollection":
        """:meth:`Metric.set_dtype` on every member; compute groups share the
        cast states again."""
        for m in self._modules.values():
            m.set_dtype(dst_type)
        if self._groups_checked:
            self._share_group_states()
        return self

    def float(self) -> "MetricCollection":  # type: ignore[override]
        return self.set_dtype(torch.float32)

    def double(self) -> "MetricCollection":  # type: ignore[override]
        """float32 states, as :meth:`Metric.double`."""
        return self.set_dtype(torch.float64)

    def half(self) -> "MetricCollection":  # type: ignore[override]
        """bfloat16 states, as :meth:`Metric.half` (not ``nn.Module.half``'s float16)."""
        return self.set_dtype(torch.bfloat16)

    def reset(self) -> None:
        for m in self._modules.values():
            m.reset()
        if self._groups_checked:
            self._share_group_states()

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MetricCollection":
        mc = deepcopy(self)
        if prefix:
            mc.prefix = self._check_arg(prefix, "prefix")
        if postfix:
            mc.postfix = self._check_arg(postfix, "postfix")
        return mc

    def persistent(self, mode: bool = True) -> None:
        for m in self._modules.values():
            m.persistent(mode)

    # ------------------------------------------------------------- dict sugar
    def _to_key(self, base: str) -> str:
        if self.prefix:
            base = self.prefix + base
        if self.postfix:
            base = base + self.postfix
        return base

    def keys(self, keep_base: bool = False) -> Iterable[str]:
        if keep_base:
            return self._modules.keys()
        return [self._to_key(k) for k in self._modules]

    def values(self) -> Iterable[Metric]:
        return self._modules.values()

    def items(self, keep_base: bool = False) -> Iterable[Tuple[str, Metric]]:
        if keep_base:
            return self._modules.items()
        return [(self._to_key(k), v) for k, v in self._modules.items()]

    def __getitem__(self, key: str) -> Metric:
        return self._modules[key]

    def __len__(self) -> int:
        return len(self._modules)

    def __iter__(self):
        return iter(self.keys())

    @property
    def compute_groups(self) -> Dict[int, List[str]]:
        return self._compute_groups

    @property
    def last_sync_report(self) -> Dict[str, Optional[Dict[str, Any]]]:
        """Per-member sync telemetry, ``{name: metric.last_sync_report}``
        (``None`` for members that have not attempted a distributed sync)."""
        return {name: m.last_sync_report for name, m in self._modules.items()}

    @property
    def sync_report_history(self) -> Dict[str, List[Dict[str, Any]]]:
        """Per-member bounded report rings: ``{name: [oldest, ..., newest]}``."""
        return {name: list(m.sync_report_history) for name, m in self._modules.items()}

    def aggregate_sync_report(self) -> Dict[str, Any]:
        """Roll every member's latest sync report into collection totals.

        Sums the additive fields (duration, retries, attempts, gather calls,
        bytes, preflight traffic, backoff, async overlap) and collects
        per-member errors, so
        a loop can log one line per collection sync.
        """
        totals: Dict[str, Any] = {
            "members_reporting": 0,
            "duration_secs": 0.0,
            "retries": 0,
            "attempts": 0,
            "gather_calls": 0,
            "bytes_gathered": 0,
            "preflight_calls": 0,
            "preflight_bytes": 0,
            "bytes_saved": 0,
            "delta_syncs": 0,
            "full_syncs": 0,
            "backoff_secs": 0.0,
            "overlap_secs": 0.0,
            "errors": [],
        }
        for name, m in self._modules.items():
            rep = m.last_sync_report
            if not rep:
                continue
            totals["members_reporting"] += 1
            for key in ("duration_secs", "backoff_secs", "overlap_secs"):
                totals[key] = round(totals[key] + float(rep.get(key) or 0.0), 6)
            for key in (
                "retries", "attempts", "gather_calls", "bytes_gathered",
                "preflight_calls", "preflight_bytes", "bytes_saved",
            ):
                totals[key] += int(rep.get(key) or 0)
            if "delta" in rep:
                totals["delta_syncs" if rep["delta"] else "full_syncs"] += 1
            if rep.get("error"):
                totals["errors"].append({"member": name, "error": rep["error"]})
        return totals
