"""Checkpoint storage: crash-consistent local filesystem store + chaos wrapper
(counterpart of ``metrics_tpu/checkpoint/store.py``; plain Python).

``LocalStore`` is the only thing that touches the filesystem.  Every write
is tmp-file -> flush -> fsync -> rename -> fsync(parent dir), so a reader
either sees the complete previous version or the complete new one — never a
torn file.  Deletes go through a rename-to-trash first, so a crash mid-GC
leaves trash directories (swept on the next GC pass) instead of a
half-deleted checkpoint that still looks committed.

``ChaosStore`` wraps any store and injects the storage failure modes the
restore path must survive: torn writes (power cut mid-write on a filesystem
without atomic rename), dropped writes (crash before rename), bit flips
(media corruption), missing files (lost shard), and stale reads (a manifest
from an older incarnation).  It is the filesystem sibling of
:class:`metrics_tpu_torch.parallel.ChaosBackend`.

The JAX package also counts injected faults in its observability counters
(``ckpt.chaos_faults``); the port has no such counters yet, and
``ChaosStore.injected`` records every injection.
"""

from __future__ import annotations

import os
import shutil
import uuid
from typing import Dict, List, Optional, Tuple

from metrics_tpu_torch.obs import counter_inc

_TRASH_PREFIX = ".trash."


class LocalStore:
    """Atomic-rename filesystem store rooted at ``root``.

    Paths handed to the store are ``/``-separated and relative to the root;
    the store owns directory creation.  ``bytes_written`` and ``fsyncs``
    count what the store has written and flushed since it was built.
    """

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(os.fspath(root))
        os.makedirs(self.root, exist_ok=True)
        self.bytes_written = 0
        self.fsyncs = 0

    def _abs(self, path: str) -> str:
        return os.path.join(self.root, *path.split("/"))

    def write_atomic(self, path: str, data: bytes) -> None:
        """Write ``data`` so that ``path`` is either fully old or fully new.

        tmp file in the same directory (rename must not cross filesystems),
        fsync the data, atomic rename over the final name, then fsync the
        parent directory so the rename itself survives a power cut.
        """
        final = self._abs(path)
        parent = os.path.dirname(final)
        os.makedirs(parent, exist_ok=True)
        tmp = os.path.join(parent, f".tmp.{uuid.uuid4().hex}")
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            self.fsyncs += 1
            self.bytes_written += len(data)
            os.replace(tmp, final)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._fsync_dir(parent)

    def _fsync_dir(self, path: str) -> None:
        try:
            fd = os.open(path, os.O_RDONLY)
        except OSError:  # platforms without directory fds
            return
        try:
            os.fsync(fd)
            self.fsyncs += 1
        finally:
            os.close(fd)

    def read(self, path: str) -> bytes:
        with open(self._abs(path), "rb") as f:
            return f.read()

    def exists(self, path: str) -> bool:
        return os.path.exists(self._abs(path))

    def listdir(self, path: str = "") -> List[str]:
        target = self._abs(path) if path else self.root
        try:
            return sorted(os.listdir(target))
        except FileNotFoundError:
            return []

    def remove_tree(self, path: str) -> None:
        """Crash-safe recursive delete: atomically rename out of the way
        first, so no reader can observe a partially deleted checkpoint."""
        final = self._abs(path)
        if not os.path.exists(final):
            return
        trash = os.path.join(
            os.path.dirname(final), _TRASH_PREFIX + os.path.basename(final) + "." + uuid.uuid4().hex
        )
        os.replace(final, trash)
        self._fsync_dir(os.path.dirname(final))
        shutil.rmtree(trash, ignore_errors=True)

    def sweep_trash(self, path: str = "") -> int:
        """Remove trash left by a crash mid-:meth:`remove_tree`."""
        target = self._abs(path) if path else self.root
        swept = 0
        try:
            entries = os.listdir(target)
        except FileNotFoundError:
            return 0
        for entry in entries:
            if entry.startswith(_TRASH_PREFIX) or entry.startswith(".tmp."):
                full = os.path.join(target, entry)
                if os.path.isdir(full):
                    shutil.rmtree(full, ignore_errors=True)
                else:
                    try:
                        os.unlink(full)
                    except OSError:
                        pass
                swept += 1
        return swept


class ChaosStore:
    """Fault-injecting wrapper around a store (default: a fresh LocalStore).

    ``faults`` is a list of ``(kind, path_substring)`` pairs; each fires
    (once) on the first matching operation and is then spent:

    - ``"torn_write"``: writes only the first half of the payload, straight
      to the final path — the torn file a non-atomic filesystem leaves.
    - ``"drop_write"``: silently skips the write — a crash before rename.
    - ``"bit_flip"``: flips one bit in the middle of the payload on read.
    - ``"missing"``: read raises FileNotFoundError — a lost shard.
    - ``"stale"``: keeps serving the file's content as of the moment the
      fault arms, ignoring later writes — an old manifest surviving a
      botched overwrite.

    Injections are recorded in ``injected`` for assertion in tests.
    """

    def __init__(self, inner: LocalStore, faults: Optional[List[Tuple[str, str]]] = None) -> None:
        valid = ("torn_write", "drop_write", "bit_flip", "missing", "stale")
        self.inner = inner
        self.faults: List[Tuple[str, str]] = []
        for kind, substr in faults or []:
            if kind not in valid:
                raise ValueError(f"unknown chaos fault {kind!r}; expected one of {valid}")
            self.faults.append((kind, substr))
        self.injected: List[Tuple[str, str]] = []
        self._stale_copies: Dict[str, bytes] = {}
        self.root = inner.root

    def _take(self, path: str, *kinds: str) -> Optional[str]:
        for i, (kind, substr) in enumerate(self.faults):
            if kind in kinds and substr in path:
                del self.faults[i]
                self.injected.append((kind, path))
                counter_inc("ckpt.chaos_faults", kind=kind)
                return kind
        return None

    def _arm_stale(self, path: str) -> bool:
        """Stale faults capture content at write/arm time, then linger."""
        for kind, substr in self.faults:
            if kind == "stale" and substr in path:
                return True
        return False

    def write_atomic(self, path: str, data: bytes) -> None:
        if self._arm_stale(path) and path not in self._stale_copies:
            if self.inner.exists(path):
                self._stale_copies[path] = self.inner.read(path)
            else:
                # nothing older to serve: the stale fault becomes a drop so
                # the manifest from the previous step stays the newest
                self._take(path, "stale")
                self.injected.append(("stale->drop", path))
                return
        kind = self._take(path, "torn_write", "drop_write")
        if kind == "drop_write":
            return
        if kind == "torn_write":
            # bypass the atomic path on purpose: final name, half the bytes
            final = os.path.join(self.inner.root, *path.split("/"))
            os.makedirs(os.path.dirname(final), exist_ok=True)
            with open(final, "wb") as f:
                f.write(data[: len(data) // 2])
            return
        self.inner.write_atomic(path, data)

    def read(self, path: str) -> bytes:
        if self._take(path, "missing") is not None:
            raise FileNotFoundError(path)
        if path in self._stale_copies:
            self._take(path, "stale")
            return self._stale_copies[path]
        data = self.inner.read(path)
        if self._take(path, "bit_flip") is not None and data:
            mid = len(data) // 2
            data = data[:mid] + bytes([data[mid] ^ 0x10]) + data[mid + 1 :]
        return data

    def exists(self, path: str) -> bool:
        return self.inner.exists(path)

    def listdir(self, path: str = "") -> List[str]:
        return self.inner.listdir(path)

    def remove_tree(self, path: str) -> None:
        self.inner.remove_tree(path)

    def sweep_trash(self, path: str = "") -> int:
        return self.inner.sweep_trash(path)
