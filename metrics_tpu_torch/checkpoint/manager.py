"""Preemption-safe checkpoint manager for metric state
(counterpart of ``metrics_tpu/checkpoint/manager.py``).

``CheckpointManager`` snapshots a :class:`~metrics_tpu_torch.Metric`,
:class:`~metrics_tpu_torch.MetricCollection`, or
:class:`~metrics_tpu_torch.MetricTracker` to durable storage and restores it after
a preemption, with three guarantees:

* **Crash consistency.**  Each rank writes its shard through the store's
  tmp -> fsync -> rename path; the manifest is written LAST, only after every
  rank's shard metadata is visible, so a manifest's existence IS the commit
  record.  A checkpoint killed at any instant is either fully committed or
  invisible to restore.
* **Integrity.**  The manifest carries a blake2b digest for every packed
  state blob of every shard.  Restore re-hashes each blob and routes
  mismatches through the ``on_restore_error`` policy
  (``"raise" | "skip_state" | "reset_metric"`` — mirroring the sync layer's
  ``on_sync_error``).
* **Elasticity.**  A checkpoint taken at world size M restores into world
  size N for any M, N >= 1: each rank loads its primary shard bit-exactly
  and folds the shards of vanished ranks through the same multi-way
  ``merge_state`` path cross-host sync uses, so post-restore ``compute()``
  matches the uninterrupted run.

A metric placed on a device mesh (:meth:`Metric.shard`) encodes its whole
value (a collective over its mesh, inside ``encode_metric``) into the shard
of the mesh's first rank; every other rank's shard holds the metric's empty
state.  So any restore folds to the whole value once: an unplaced target
folds the shards as usual, and a placed target loads the first rank's shard
on every rank and keeps its share of it.

Multi-process coordination uses the key-value store of the default
``torch.distributed`` process group when one is up (snapshot barrier, commit
broadcast, restore quorum on which step to load), under the JAX package's key
names ``mtpu/ckpt/{ns}/...``, and falls back to polling the shared checkpoint
directory when it is not: the directory must be shared storage either way.
The on-disk layout (step directories, shard and shard-metadata names, the
manifest's JSON) is the JAX package's, so either package restores the
other's checkpoints.

Saves and restores are timed by the ``ckpt.save`` / ``ckpt.restore`` spans
and counted under the JAX package's ``ckpt.*`` counter names.
"""

from __future__ import annotations

import base64
import copy
import datetime
import hashlib
import itertools
import json
import os
import re
import threading
import time
import warnings
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.checkpoint import codec
from metrics_tpu_torch.checkpoint.store import ChaosStore, LocalStore
from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric, _pack_state_blob, _unpack_state_blob
from metrics_tpu_torch.obs import counter_inc, span
from metrics_tpu_torch.utils.exceptions import (
    CheckpointError,
    CheckpointIntegrityError,
    CheckpointRestoreError,
)
from metrics_tpu_torch.wrappers.tracker import MetricTracker

MANIFEST_NAME = "MANIFEST.json"
_STEP_DIR_RE = re.compile(r"^step_(\d{8})$")
_TRACKER_STEP_RE_TMPL = r"step(\d{4})/"

Target = Union[Metric, MetricCollection, MetricTracker]

_RESTORE_POLICIES = ("raise", "skip_state", "reset_metric")


@dataclass
class EncodedTarget:
    """Serialized metric blobs ready to commit — the output of
    :meth:`CheckpointManager.encode_target`, accepted by
    :meth:`CheckpointManager.save`.

    Splitting serialization from the store/barrier commit lets a serving
    process encode each metric under its own short per-job lock and run the
    (slow, possibly faulted) store writes with no lock held at all.
    """

    shard_blobs: Dict[str, bytes]
    shard_meta: Dict[str, Any]
    manifest_schema: Dict[str, Any]


def shard_checkpoint_directory(root: str, shard: int) -> str:
    """Checkpoint root for ONE serve-fleet shard under a shared fleet root.

    Each shard worker owns an independent manifest lineage (its own steps,
    retention, and staleness clock), so a replacement worker for shard ``i``
    restores exactly shard ``i``'s last committed state — the failover
    contract of the sharded serve tier — and two shards can never tear each
    other's commits.
    """
    if int(shard) < 0:
        raise ValueError(f"shard must be >= 0, got {shard}")
    return os.path.join(str(root), f"shard_{int(shard):04d}")


# ---------------------------------------------------------------------------
# Elastic span transfer: the PR-5 restore path specialized to row ranges.
#
# A fleet resize moves contiguous stream spans between shard workers.  The
# payloads below are the wire format: the donor's row-range slice of every
# stacked ``(S, ...)`` state (or, for a plain job, its whole encoded state)
# packed with the checkpoint codec's blob packer and integrity-checked with
# the same blake2b digest the manifest uses — a corrupted or truncated
# transfer raises instead of silently seeding a recipient with garbage.
# Everything is base64-JSON so the same payload rides the in-process handle
# and the worker HTTP surface unchanged.
# ---------------------------------------------------------------------------


def encode_stream_span(metric: Metric, lo: int, hi: int) -> Dict[str, Any]:
    """Pack rows ``[lo, hi)`` of a multistream metric's stacked states.

    Returns a jsonable payload ``{"lo", "hi", "rows", "blob", "digest"}``;
    ``rows`` is the slice's accepted-row total (the recipient's update-count
    credit), ``digest`` guards the packed bytes end to end.  Beyond the JAX
    package's payload, ``"extra"`` carries the metric's checkpointed
    attributes (a classifier's input ``mode``), so a recipient answers a
    query before its first rows; the JAX package's span loses them, and its
    resized ``Accuracy`` shards raise until new rows arrive.
    """
    arrays = metric.stream_slice(lo, hi)
    blob = _pack_state_blob(arrays)
    rows_vec = arrays.get("stream_rows")
    out = {
        "lo": int(lo),
        "hi": int(hi),
        "rows": int(rows_vec.sum()) if rows_vec is not None else 0,
        "blob": base64.b64encode(blob).decode("ascii"),
        "digest": codec.state_digest(blob),
    }
    extra = metric._ckpt_extra_state()
    if extra:
        out["extra"] = extra
    return out


def decode_stream_span(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Verify and unpack one :func:`encode_stream_span` payload.

    Returns ``{key: tensor}`` CPU slice arrays for
    :meth:`MultiStreamMetric.adopt_stream_slice`; raises
    :class:`CheckpointIntegrityError` when the digest does not match.
    """
    blob = base64.b64decode(payload["blob"])
    expect = payload.get("digest")
    if codec.state_digest(blob) != expect:
        raise CheckpointIntegrityError(
            f"stream span [{payload.get('lo')}, {payload.get('hi')}) failed "
            "its transfer digest; refusing to seed the recipient"
        )
    return _unpack_state_blob(blob)


def encode_metric_transfer(metric: Metric) -> Dict[str, Any]:
    """Pack a whole metric (plain-job migration) as a jsonable payload."""
    encoded = codec.encode_metric(metric)
    return {
        "blob": base64.b64encode(encoded.blob).decode("ascii"),
        "digests": dict(encoded.digests),
        "update_count": int(encoded.update_count),
    }


def apply_metric_transfer(metric: Metric, payload: Dict[str, Any]) -> None:
    """Load one :func:`encode_metric_transfer` payload into a fresh metric.

    The primary-shard restore path bit-for-bit: decode with digest
    verification, rebuild the state pytree, load it.  Any failed state is a
    hard error — migration moves live state between healthy workers, so
    unlike a disk restore there is no "better stale than dead" policy.
    """
    blob = base64.b64decode(payload["blob"])
    decoded = codec.decode_metric(blob, dict(payload["digests"]))
    if decoded.failed:
        raise CheckpointIntegrityError(
            f"metric transfer failed digest check for state(s) "
            f"{sorted(decoded.failed)}"
        )
    metric.load_state_pytree(codec.arrays_to_pytree(metric, decoded.arrays))


def _step_dir(step: int) -> str:
    return f"step_{step:08d}"


def _shard_name(rank: int) -> str:
    return f"shard_{rank:05d}.bin"


def _shard_meta_name(rank: int) -> str:
    return f"shard_{rank:05d}.meta.json"


def flatten_target(target: Target, prefix: str = "") -> Dict[str, Metric]:
    """Flatten a checkpoint target into ``{key: metric}``.

    Keys are stable across processes and across save/restore:
    ``"metric"`` for a bare metric, ``"col/{name}"`` per collection member
    (compute-group members included — their shared state is saved
    redundantly and re-aliased after restore), and
    ``"base/..."``/``"step{i:04d}/..."`` recursions for a tracker.
    """
    if isinstance(target, MetricTracker):
        out: Dict[str, Metric] = {}
        out.update(flatten_target(target._base_metric, prefix + "base/"))
        for i, step in enumerate(target._steps):
            out.update(flatten_target(step, prefix + f"step{i:04d}/"))
        return out
    if isinstance(target, MetricCollection):
        return {prefix + "col/" + name: m for name, m in target.items(keep_base=True)}
    if isinstance(target, Metric):
        return {prefix + "metric": target}
    raise TypeError(f"cannot checkpoint {type(target).__name__}; expected Metric, MetricCollection, or MetricTracker")


def _prepare_target_structure(target: Target, keys: List[str], prefix: str = "") -> None:
    """Rebuild dynamic structure (tracker steps) to match a manifest's keys
    BEFORE per-metric state restore overwrites the snapshots."""
    if isinstance(target, MetricTracker):
        pat = re.compile(re.escape(prefix) + _TRACKER_STEP_RE_TMPL)
        steps = {int(m.group(1)) for k in keys for m in [pat.match(k)] if m}
        n = max(steps) + 1 if steps else 0
        target._steps = []
        target._increment_called = False
        for _ in range(n):
            target.increment()
        if n == 0:
            target._increment_called = False
        _prepare_target_structure(target._base_metric, keys, prefix + "base/")
        for i, step in enumerate(target._steps):
            _prepare_target_structure(step, keys, prefix + f"step{i:04d}/")


def _finalize_restore(target: Target) -> None:
    """Re-establish invariants that per-metric restore cannot see."""
    if isinstance(target, MetricTracker):
        _finalize_restore(target._base_metric)
        for step in target._steps:
            _finalize_restore(step)
    elif isinstance(target, MetricCollection):
        if target._groups_checked:
            target._share_group_states()


@dataclass
class RestoreResult:
    """What :meth:`CheckpointManager.restore` actually did."""

    step: int
    world_size: int  # world size the checkpoint was TAKEN at
    restored_metrics: List[str] = field(default_factory=list)
    folded_shards: List[int] = field(default_factory=list)  # elastic merges on this rank
    skipped_states: List[Tuple[str, str]] = field(default_factory=list)  # (metric, state)
    reset_metrics: List[str] = field(default_factory=list)
    missing_shards: List[int] = field(default_factory=list)
    stale_steps: List[int] = field(default_factory=list)  # uncommitted/corrupt steps skipped
    # opaque caller state saved alongside this rank's primary shard (e.g. the
    # serve tier's WAL applied-seq watermarks); None when the checkpoint
    # carried none or the primary shard's metadata was unreadable
    extra: Optional[Dict[str, Any]] = None


class CheckpointManager:
    """Atomic, integrity-checked snapshot/restore of metric state.

    Args:
        directory: checkpoint root (shared storage in multihost runs).
            Ignored when ``store`` is passed.
        keep_last: retention — newest K committed checkpoints survive GC
            (``None`` disables GC).
        on_restore_error: what a digest mismatch / unreadable blob does:
            ``"raise"`` a :class:`CheckpointIntegrityError`, ``"skip_state"``
            restore every verified state and leave failed ones at their
            defaults, or ``"reset_metric"`` leave the whole affected metric
            reset.  Missing rank shards follow the same policy (``"raise"``
            becomes :class:`CheckpointRestoreError`; the other two continue
            with the shards that exist).
        store: a pre-built store (e.g. a :class:`ChaosStore`) instead of a
            ``LocalStore(directory)``.
        rank / world_size: override process identity (defaults to the rank
            and world size of the default ``torch.distributed`` group when
            one is initialized, else 0 and 1): lets tests emulate several
            ranks from one process.
        barrier_timeout: seconds to wait on peers during save commit and
            restore quorum.
        max_staleness: cadence seam for long-running callers (the serve
            durability loop): when set, :meth:`save_due` turns true once the
            newest durable state is older than this many seconds, and
            :meth:`maybe_save` commits a checkpoint exactly then.  The clock
            starts at construction (or the last save/restore), so a
            freshly-started caller does not checkpoint immediately.  ``None``
            (default) means :meth:`maybe_save` only fires on an explicit
            :meth:`request_save`.
    """

    def __init__(
        self,
        directory: Optional[str] = None,
        *,
        keep_last: Optional[int] = 3,
        on_restore_error: str = "raise",
        store: Optional[Union[LocalStore, ChaosStore]] = None,
        rank: Optional[int] = None,
        world_size: Optional[int] = None,
        barrier_timeout: float = 120.0,
        max_staleness: Optional[float] = None,
    ) -> None:
        if store is None:
            if directory is None:
                raise ValueError("pass `directory` or a pre-built `store`")
            store = LocalStore(directory)
        if on_restore_error not in _RESTORE_POLICIES:
            raise ValueError(
                f"`on_restore_error` must be one of {_RESTORE_POLICIES}, got {on_restore_error!r}"
            )
        if keep_last is not None and keep_last < 1:
            raise ValueError(f"`keep_last` must be >= 1 or None, got {keep_last}")
        self.store = store
        self.keep_last = keep_last
        self.on_restore_error = on_restore_error
        dist = torch.distributed
        grouped = dist.is_available() and dist.is_initialized()
        self.rank = (dist.get_rank() if grouped else 0) if rank is None else int(rank)
        self.world_size = (dist.get_world_size() if grouped else 1) if world_size is None else int(world_size)
        self.barrier_timeout = float(barrier_timeout)
        if max_staleness is not None and not max_staleness > 0:
            raise ValueError(f"`max_staleness` must be > 0 or None, got {max_staleness}")
        self.max_staleness = None if max_staleness is None else float(max_staleness)
        # staleness clock + "checkpoint now" trigger (set from any thread or a
        # signal handler; honored by the next maybe_save)
        self._durable_at = time.monotonic()
        self._save_requested = threading.Event()
        # coordination-key namespace: shared by every rank's manager for the
        # same directory, disjoint across directories
        self._ns = hashlib.blake2b(self.store.root.encode(), digest_size=6).hexdigest()
        self._op_seq = itertools.count()

    # ------------------------------------------------------------------ save

    def encode_target(
        self, target: Target, lock_for: Optional[Any] = None
    ) -> EncodedTarget:
        """Serialize every metric in ``target`` to its checkpoint blobs.

        Pure host-side work — no store writes, no barriers.  ``lock_for``
        (``key -> context manager``) is entered around each metric's encode,
        so a serving process can hold one short per-job lock per metric
        instead of quiescing the whole registry for the full snapshot; the
        result is per-metric-consistent rather than cross-metric
        point-in-time, which is exactly the consistency the restore path
        needs (each metric restores independently).
        """
        metrics = flatten_target(target)
        shard_meta: Dict[str, Any] = {"metrics": {}}
        manifest_schema: Dict[str, Any] = {}
        shard_blobs: Dict[str, bytes] = {}
        for key, metric in metrics.items():
            with (lock_for(key) if lock_for is not None else nullcontext()):
                enc = codec.encode_metric(metric)
                if metric._placement is not None and metric._axis_rank()[0] != 0:
                    # the first rank of the mesh holds the whole value: this shard is empty
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")  # the copy's shares are reset at once
                        empty = copy.deepcopy(metric)
                    empty.reset()
                    enc = codec.encode_metric(empty)
            shard_blobs[key] = enc.blob
            shard_meta["metrics"][key] = {
                "digests": enc.digests,
                "update_count": enc.update_count,
                "sync_round": enc.sync_round,
            }
            manifest_schema[key] = {"type": type(metric).__name__, "kinds": enc.kinds}
        return EncodedTarget(
            shard_blobs=shard_blobs,
            shard_meta=shard_meta,
            manifest_schema=manifest_schema,
        )

    def save(
        self,
        target: Target,
        step: Optional[int] = None,
        encoded: Optional[EncodedTarget] = None,
        extra: Optional[Dict[str, Any]] = None,
    ) -> int:
        """Commit one checkpoint of ``target``; returns the step committed.

        All ranks must call this collectively with the same ``step`` (or all
        with ``None``, which continues from the newest committed step).  The
        manifest write by rank 0 is the commit point; every rank returns only
        after observing it, so a ``save()`` that returned is durable.

        Pass ``encoded`` (from :meth:`encode_target`) to commit blobs that
        were serialized earlier — the non-blocking snapshot path.

        ``extra`` is an opaque JSON-serializable dict committed atomically
        with this rank's shard (it rides the shard metadata, inside the
        manifest commit); :meth:`restore` hands it back via
        ``RestoreResult.extra``.  The serve tier stores its WAL applied-seq
        watermarks here so "state" and "how far the log is folded in" can
        never commit separately.
        """
        if step is None:
            latest = self.latest_step()
            step = 0 if latest is None else latest + 1
        seq = next(self._op_seq)
        with span("ckpt.save", step=step, rank=self.rank):
            self._barrier(f"save-entry/{seq}/{step}")
            sdir = _step_dir(step)
            if encoded is None:
                encoded = self.encode_target(target)
            shard_meta = encoded.shard_meta
            if extra is not None:
                shard_meta = dict(shard_meta)
                shard_meta["extra"] = extra
            manifest_schema = encoded.manifest_schema
            shard = _pack_state_blob(
                {key: codec._as_bytes_tensor(blob) for key, blob in encoded.shard_blobs.items()}
            )
            self.store.write_atomic(f"{sdir}/{_shard_name(self.rank)}", shard)
            counter_inc("ckpt.bytes_written", value=len(shard))
            self.store.write_atomic(
                f"{sdir}/{_shard_meta_name(self.rank)}",
                json.dumps(shard_meta, sort_keys=True).encode(),
            )
            if self.rank == 0:
                shards = self._collect_shard_metas(sdir)
                manifest = {
                    "format_version": codec.FORMAT_VERSION,
                    "step": step,
                    "world_size": self.world_size,
                    "metrics": manifest_schema,
                    "shards": shards,
                }
                # the commit point: a step directory without this file is
                # invisible to restore
                payload = json.dumps(manifest, sort_keys=True).encode()
                self.store.write_atomic(f"{sdir}/{MANIFEST_NAME}", payload)
                self._verify_commit(sdir, step, payload)
                self._kv_publish(f"commit/{seq}/{step}", "1")
                if self.keep_last is not None:
                    self._gc(keep_step=step)
            else:
                self._await_commit(seq, step, sdir)
            counter_inc("ckpt.saves")
        self._durable_at = time.monotonic()
        return step

    # ------------------------------------------------------- cadence triggers

    def request_save(self) -> None:
        """Arm the "checkpoint now" trigger: the next :meth:`maybe_save` (or
        :meth:`save_now`) commits regardless of staleness.  Safe to call from
        any thread or a signal handler — the preemption-notice hook."""
        self._save_requested.set()

    def staleness(self) -> float:
        """Seconds since the target was last known durable (last successful
        ``save``/``restore`` through this manager, else construction)."""
        return time.monotonic() - self._durable_at

    def save_due(self) -> bool:
        """Whether the cadence says it is time to checkpoint: an armed
        :meth:`request_save`, or ``max_staleness`` exceeded."""
        if self._save_requested.is_set():
            return True
        return self.max_staleness is not None and self.staleness() >= self.max_staleness

    def seconds_until_due(self) -> Optional[float]:
        """How long a durability loop may sleep before :meth:`save_due` turns
        true (0 when already due, ``None`` when only an explicit
        :meth:`request_save` can trigger)."""
        if self._save_requested.is_set():
            return 0.0
        if self.max_staleness is None:
            return None
        return max(0.0, self.max_staleness - self.staleness())

    def save_now(
        self,
        target: Target,
        step: Optional[int] = None,
        encoded: Optional[EncodedTarget] = None,
        extra: Optional[Dict[str, Any]] = None,
    ) -> int:
        """Unconditional checkpoint: commit, disarm any pending
        :meth:`request_save`, and reset the staleness clock."""
        committed = self.save(target, step=step, encoded=encoded, extra=extra)
        self._save_requested.clear()
        return committed

    def maybe_save(self, target: Target, step: Optional[int] = None) -> Optional[int]:
        """Commit a checkpoint iff :meth:`save_due`; returns the committed
        step, or ``None`` when nothing was due.  The cadence primitive for
        durability loops — callers stop hand-rolling last-save bookkeeping."""
        if not self.save_due():
            return None
        counter_inc("ckpt.triggered_saves")
        return self.save_now(target, step=step)

    def _verify_commit(self, sdir: str, step: int, payload: bytes) -> None:
        """Read the manifest back and make sure the commit actually stuck.

        A torn or dropped write (non-atomic filesystem, crash inside the
        storage layer) must fail the ``save()`` call itself — a save that
        returned successfully is a durability promise.
        """
        try:
            readback = self.store.read(f"{sdir}/{MANIFEST_NAME}")
        except FileNotFoundError:
            readback = None
        if readback != payload:
            raise CheckpointError(
                f"step {step} manifest commit did not persist (torn or dropped "
                "write); the checkpoint is invisible to restore"
            )

    def _collect_shard_metas(self, sdir: str) -> Dict[str, Any]:
        """Rank 0: wait until every rank's shard metadata is durable."""
        deadline = time.monotonic() + self.barrier_timeout
        shards: Dict[str, Any] = {}
        while True:
            for r in range(self.world_size):
                if str(r) in shards:
                    continue
                path = f"{sdir}/{_shard_meta_name(r)}"
                if self.store.exists(path):
                    shards[str(r)] = json.loads(self.store.read(path).decode())
            if len(shards) == self.world_size:
                return shards
            if time.monotonic() > deadline:
                missing = [r for r in range(self.world_size) if str(r) not in shards]
                raise CheckpointError(
                    f"save timed out after {self.barrier_timeout:.0f}s waiting for "
                    f"shard metadata from rank(s) {missing}"
                )
            time.sleep(0.05)

    def _await_commit(self, seq: int, step: int, sdir: str) -> None:
        """Ranks != 0: block until rank 0's manifest commit is visible."""
        client = self._kv_client()
        if client is not None:
            try:
                client.wait([self._kv_key(f"commit/{seq}/{step}")], self._timeout())
                return
            except Exception as err:
                raise CheckpointError(f"save commit wait failed: {err}") from err
        deadline = time.monotonic() + self.barrier_timeout
        while not self.store.exists(f"{sdir}/{MANIFEST_NAME}"):
            if time.monotonic() > deadline:
                raise CheckpointError(
                    f"save timed out after {self.barrier_timeout:.0f}s waiting for the "
                    f"step {step} manifest commit from rank 0"
                )
            time.sleep(0.05)

    # --------------------------------------------------------------- restore

    def restore(self, target: Target, step: Optional[int] = None) -> RestoreResult:
        """Restore ``target`` from the newest usable checkpoint (or ``step``).

        Collective: in multihost runs every rank must call it and the quorum
        picks the newest step ALL ranks see committed with an identical
        manifest, skipping torn/stale steps.  Raises
        :class:`CheckpointRestoreError` when no usable checkpoint exists.
        """
        seq = next(self._op_seq)
        with span("ckpt.restore", rank=self.rank):
            stale: List[int] = []
            candidates = self._committed_manifests(stale)
            if step is not None:
                candidates = {s: m for s, m in candidates.items() if s == step}
            chosen = self._quorum(seq, candidates)
            if chosen is None:
                raise CheckpointRestoreError(
                    f"no usable checkpoint under {self.store.root!r}"
                    + (f" for step {step}" if step is not None else "")
                    + (f" (skipped uncommitted/stale step(s) {sorted(stale)})" if stale else "")
                )
            manifest = candidates[chosen]
            result = RestoreResult(
                step=chosen, world_size=int(manifest["world_size"]), stale_steps=sorted(stale)
            )
            self._restore_from_manifest(target, manifest, result)
            counter_inc("ckpt.restores")
        # the restored state IS durable: restart the staleness clock from it
        self._durable_at = time.monotonic()
        return result

    def latest_step(self) -> Optional[int]:
        """Newest committed (manifest-consistent) step, or ``None``."""
        committed = self._committed_manifests([])
        return max(committed) if committed else None

    def _committed_manifests(self, stale_out: List[int]) -> Dict[int, Dict[str, Any]]:
        """Step dirs whose manifest parses, matches its directory's step, and
        speaks this format version.  Everything else is stale/torn."""
        out: Dict[int, Dict[str, Any]] = {}
        for entry in self.store.listdir():
            m = _STEP_DIR_RE.match(entry)
            if not m:
                continue
            dir_step = int(m.group(1))
            path = f"{entry}/{MANIFEST_NAME}"
            try:
                manifest = json.loads(self.store.read(path).decode())
            except FileNotFoundError:
                continue  # never committed (crash before manifest) — not stale
            except Exception:
                stale_out.append(dir_step)
                counter_inc("ckpt.stale_manifests")
                continue
            if (
                not isinstance(manifest, dict)
                or manifest.get("step") != dir_step
                or manifest.get("format_version") != codec.FORMAT_VERSION
            ):
                stale_out.append(dir_step)
                counter_inc("ckpt.stale_manifests")
                continue
            out[dir_step] = manifest
        return out

    def _quorum(self, seq: int, candidates: Dict[int, Dict[str, Any]]) -> Optional[int]:
        """Agree across ranks on the newest step everyone can load.

        Each rank publishes ``{step: manifest digest}``; the chosen step is
        the highest one present on EVERY rank with the identical digest.
        Without a process group (single process / tests) the local view
        decides.
        """
        client = self._kv_client()
        mine = {
            str(s): codec.state_digest(json.dumps(m, sort_keys=True).encode())
            for s, m in candidates.items()
        }
        if client is None or self.world_size <= 1:
            return max(candidates) if candidates else None
        client.set(self._kv_key(f"quorum/{seq}/{self.rank}"), json.dumps(mine, sort_keys=True))
        views = []
        for r in range(self.world_size):
            try:
                key = self._kv_key(f"quorum/{seq}/{r}")
                client.wait([key], self._timeout())
                raw = client.get(key).decode()
            except Exception as err:
                raise CheckpointRestoreError(
                    f"restore quorum timed out waiting for rank {r}: {err}"
                ) from err
            views.append(json.loads(raw))
        agreed = [
            int(s)
            for s, digest in views[0].items()
            if all(v.get(s) == digest for v in views[1:])
        ]
        agreed = [s for s in agreed if s in candidates]
        return max(agreed) if agreed else None

    def _restore_from_manifest(
        self, target: Target, manifest: Dict[str, Any], result: RestoreResult
    ) -> None:
        sdir = _step_dir(result.step)
        ckpt_world = result.world_size
        my_shards = [s for s in range(ckpt_world) if s % self.world_size == self.rank]
        if my_shards:
            # surface the primary shard's opaque caller state (WAL
            # watermarks etc.) exactly as it was committed with the shard
            primary_meta = manifest["shards"].get(str(my_shards[0]), {})
            if isinstance(primary_meta, dict):
                result.extra = primary_meta.get("extra")
        manifest_keys = sorted(manifest["metrics"])
        _prepare_target_structure(target, manifest_keys)
        metrics = flatten_target(target)

        # read + outer-unpack each shard this rank owns (primary first)
        shard_payloads: Dict[int, Optional[Dict[str, Any]]] = {}
        for s in my_shards:
            try:
                raw = self.store.read(f"{sdir}/{_shard_name(s)}")
                shard_payloads[s] = _unpack_state_blob(raw)
            except FileNotFoundError:
                if self.on_restore_error == "raise":
                    raise CheckpointRestoreError(
                        f"checkpoint step {result.step} is missing shard {s} "
                        f"({sdir}/{_shard_name(s)})"
                    )
                counter_inc("ckpt.missing_shards")
                result.missing_shards.append(s)
                shard_payloads[s] = None
            except Exception:
                # torn shard container: unreadable as a whole
                if self.on_restore_error == "raise":
                    raise CheckpointIntegrityError(
                        f"checkpoint step {result.step} shard {s} is unreadable", shard=s
                    )
                counter_inc("ckpt.missing_shards")
                result.missing_shards.append(s)
                shard_payloads[s] = None

        for key, metric in metrics.items():
            metric.reset()
            if key not in manifest["metrics"]:
                # schema grew since the checkpoint: nothing recorded for it
                result.reset_metrics.append(key)
                continue
            restored_any = False
            primary_done = False
            shards = my_shards
            if metric._placement is not None:
                # a placed target folds every shard into the whole value on every rank and
                # keeps its share of it
                shards = list(range(ckpt_world))
                for s in shards:
                    if s not in shard_payloads:
                        try:
                            shard_payloads[s] = _unpack_state_blob(self.store.read(f"{sdir}/{_shard_name(s)}"))
                        except FileNotFoundError:
                            shard_payloads[s] = None
            for s in shards:
                payload = shard_payloads[s]
                if payload is None:
                    continue
                shard_info = manifest["shards"].get(str(s), {}).get("metrics", {}).get(key)
                if shard_info is None:
                    continue
                packed = payload.get(key)
                blob = packed.numpy().tobytes() if packed is not None else b""
                decoded = codec.decode_metric(blob, dict(shard_info["digests"]))
                if decoded.failed:
                    if self.on_restore_error == "raise":
                        raise CheckpointIntegrityError(
                            f"checkpoint step {result.step} metric {key!r}: state(s) "
                            f"{sorted(decoded.failed)} failed digest verification in shard {s}",
                            metric=key,
                            state=sorted(decoded.failed)[0],
                            shard=s,
                        )
                    counter_inc("ckpt.digest_failures", value=len(decoded.failed))
                    if self.on_restore_error == "reset_metric":
                        # one bad blob poisons the metric: any partial state
                        # already merged is discarded, it restarts from zero
                        metric.reset()
                        restored_any = False
                        break
                    result.skipped_states.extend((key, sname) for sname in sorted(decoded.failed))
                if not primary_done:
                    # bit-exact path for the rank's own shard
                    tree = codec.arrays_to_pytree(metric, decoded.arrays)
                    metric.load_state_pytree(tree)
                    primary_done = True
                else:
                    other = codec.arrays_to_merge_state(metric, decoded.arrays)
                    count = int(shard_info.get("update_count", 0))
                    metric.merge_state(other, other_count=count)
                    result.folded_shards.append(s)
                    counter_inc("ckpt.folded_shards")
                restored_any = True
            if restored_any:
                result.restored_metrics.append(key)
            else:
                result.reset_metrics.append(key)
        result.folded_shards = sorted(set(result.folded_shards))
        _finalize_restore(target)

    # -------------------------------------------------------------- GC / coord

    def _gc(self, keep_step: int) -> None:
        """Rank 0, post-commit: prune everything but the newest ``keep_last``
        committed steps (uncommitted debris older than the survivors goes
        too), then sweep crash leftovers."""
        assert self.keep_last is not None
        committed = sorted(set(self._committed_manifests([])) | {keep_step})
        survivors = set(committed[-self.keep_last :])
        for entry in self.store.listdir():
            m = _STEP_DIR_RE.match(entry)
            if not m:
                continue
            s = int(m.group(1))
            if s in survivors or s > min(survivors):
                continue
            self.store.remove_tree(entry)
            counter_inc("ckpt.gc_pruned")
        self.store.sweep_trash()

    def _kv_client(self) -> Optional["torch.distributed.Store"]:
        """The default ``torch.distributed`` group's key-value store when a
        group is up and the checkpoint spans more than one rank, else ``None``."""
        if self.world_size <= 1:
            return None
        dist = torch.distributed
        if not (dist.is_available() and dist.is_initialized()):
            return None
        try:
            return dist.distributed_c10d._get_default_store()
        except Exception:
            return None

    def _timeout(self) -> datetime.timedelta:
        return datetime.timedelta(seconds=self.barrier_timeout)

    def _kv_key(self, suffix: str) -> str:
        return f"mtpu/ckpt/{self._ns}/{suffix}"

    def _kv_publish(self, suffix: str, payload: str) -> None:
        client = self._kv_client()
        if client is None:
            return
        try:
            client.set(self._kv_key(suffix), payload)
        except Exception:
            pass  # peers fall back to store polling

    def _barrier(self, name: str) -> None:
        """Snapshot barrier: every rank enters the same save round before any
        shard bytes move (catches a rank checkpointing a different step).
        Built from the store's ``add`` and ``wait``: the last rank to arrive
        sets the key every rank waits on."""
        client = self._kv_client()
        if client is None:
            return
        key = self._kv_key(name)
        try:
            if client.add(key + "/arrived", 1) == self.world_size:
                client.set(key + "/open", "1")
            client.wait([key + "/open"], self._timeout())
        except Exception as err:
            raise CheckpointError(f"checkpoint barrier {name!r} failed: {err}") from err
