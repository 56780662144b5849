"""Write-ahead log for durable ingest: segmented frames, group-commit fsync
(counterpart of ``metrics_tpu/serve/wal.py``; its frames byte for byte).

The fleet's ack contract before this module was *queue-ack*: a ``200`` from
``/ingest`` meant the rows reached an in-memory :class:`ColumnRing`, and a
SIGKILL between checkpoints lost every row past the checkpoint floor unless
the client re-sent it.  The WAL upgrades the ack to *durable-ack*: the
frontend appends each accepted columnar batch as one **frame** to a
per-shard append-only log and acks only after the frame's bytes are
fsync'd.  Checkpoints record per-job *applied-seq watermarks* (via
``CheckpointManager`` extra state), so failover replays exactly the frames
past the watermark — worker-side seq-dedup makes the replay (and any
forward retry) exactly-once.

Frame format (little-endian, versioned)::

    magic   b"MTWL"                      4 bytes
    length  u32    payload byte count
    payload:
        fixed   <HQIHBBH  version, seq, rows, arity, flags, dtype_len, job_len
        dtype   ascii     numpy dtype.str of the value columns (e.g. "<f4")
        job     utf-8     job name
        cols    arity contiguous column buffers, rows * itemsize each
        ids     rows * 4  int32 stream ids (present iff flags bit 0)
    crc32   u32    zlib.crc32 over the whole payload

A batch of scalar columns of one dtype is written exactly as the JAX
package writes it, so either package replays the other's log.  The port
also frames batches the JAX package's columnar path never carries: columns
of several dtypes, or a per-row shape (a row of logits beside its label).
Such a frame carries version 2, and its dtype field lists every column as
``dtype.str`` plus ``x``-joined per-row dims, comma-separated (``"<f4x1000,<i8"``);
column ``i`` then takes ``rows * prod(dims_i) * itemsize_i`` bytes.  The JAX
package refuses such a frame as an unsupported version.

The payload is self-describing — the same layout a future binary
``/ingest_bin`` wire protocol can reuse verbatim (ROADMAP item 4): a frame
is a columnar batch plus routing header, whether it crosses a socket or a
crash.

Durability is amortized by **group commit**: appenders enqueue encoded
frames (sequence numbers are assigned under the writer mutex, so file
order == seq order) and a single writer thread drains the queue, writes
every pending frame, and issues ONE ``fsync`` for the group.  Concurrent
producers therefore share each disk flush; a lone producer pays one fsync
per batch.  The writer thread is the single legitimately-blocking spot in
the serve tree — the ``serve-blocking`` analysis pass bans ``fsync``
elsewhere and this module opts out line-by-line, not wholesale.

Segments rotate at ``segment_bytes``; a sealed segment whose every frame
is covered by a committed checkpoint's watermarks is deleted by
:meth:`WalWriter.truncate_covered`.  Recovery semantics mirror
``CheckpointManager.on_restore_error``: a torn tail on the *last* segment
is truncated cleanly at the last valid frame (the unacked remainder was
never promised), while mid-stream corruption surfaces through
``on_error="raise" | "skip_segment"`` in :func:`replay_frames`.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import (
    Dict,
    Iterator,
    List,
    Mapping,
    NamedTuple,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np

from metrics_tpu_torch.obs import core as _obs
from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

__all__ = [
    "WalCorruption",
    "WalFrame",
    "WalTicket",
    "WalWriter",
    "inject_wal_fault",
    "list_segments",
    "read_segment_frames",
    "replay_frames",
]

_MAGIC = b"MTWL"
_FORMAT_VERSION = 1
_SHAPED_VERSION = 2  # per-column dtypes and per-row shapes in the dtype field
# version, seq, rows, arity, flags, dtype_len, job_len
_FIXED = struct.Struct("<HQIHBBH")
_LEN = struct.Struct("<I")
_FLAG_IDS = 1
_MAX_PAYLOAD = 1 << 30  # sanity bound so a corrupt length cannot OOM a read

_SEGMENT_PREFIX = "seg_"
_SEGMENT_SUFFIX = ".wal"

_REPLAY_POLICIES = ("raise", "skip_segment")


class WalCorruption(Exception):
    """A frame failed to decode: bad magic, short read, or crc mismatch."""


class WalFrame(NamedTuple):
    """One decoded append: a columnar batch plus its routing header."""

    job: str
    seq: int
    cols: Tuple[np.ndarray, ...]
    stream_ids: Optional[np.ndarray]

    @property
    def rows(self) -> int:
        return int(self.cols[0].shape[0])


class WalTicket:
    """Handle for one append: the assigned seq plus a durability latch."""

    __slots__ = ("seq", "rows", "ok", "_event")

    def __init__(self, seq: int, rows: int) -> None:
        self.seq = seq
        self.rows = rows
        self.ok = False
        self._event = threading.Event()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the frame's group commit lands; True iff durable."""
        if not self._event.wait(timeout):
            return False
        return self.ok


# ---------------------------------------------------------------------------
# frame codec


def encode_frame(
    job: str,
    seq: int,
    cols: Sequence[np.ndarray],
    stream_ids: Optional[np.ndarray] = None,
) -> bytes:
    """Serialize one columnar batch as a self-delimiting WAL frame."""
    if not cols:
        raise MetricsTPUUserError("a WAL frame needs at least one column")
    arrs = [np.ascontiguousarray(c) for c in cols]
    version = _FORMAT_VERSION
    if all(a.ndim <= 1 for a in arrs) and len({a.dtype.str for a in arrs}) == 1:
        # the JAX package's layout, byte for byte
        arrs = [a.reshape(-1) for a in arrs]
        dtype_str = arrs[0].dtype.str.encode("ascii")
    else:
        version = _SHAPED_VERSION
        dtype_str = ",".join(
            "x".join([a.dtype.str] + [str(d) for d in a.shape[1:]]) for a in arrs
        ).encode("ascii")
    rows = int(arrs[0].shape[0])
    if any(int(a.shape[0]) != rows for a in arrs):
        raise MetricsTPUUserError("ragged batch: columns disagree on row count")
    job_b = job.encode("utf-8")
    if len(job_b) > 0xFFFF or len(dtype_str) > 0xFF:
        raise MetricsTPUUserError("job name or dtype string too long for frame")
    flags = 0
    ids_b = b""
    if stream_ids is not None:
        ids = np.ascontiguousarray(stream_ids, np.int32).reshape(-1)
        if int(ids.shape[0]) != rows:
            raise MetricsTPUUserError("ragged batch: stream_ids row count mismatch")
        flags |= _FLAG_IDS
        ids_b = ids.tobytes()
    parts = [
        _FIXED.pack(
            version,
            int(seq),
            rows,
            len(arrs),
            flags,
            len(dtype_str),
            len(job_b),
        ),
        dtype_str,
        job_b,
    ]
    parts.extend(a.tobytes() for a in arrs)
    parts.append(ids_b)
    payload = b"".join(parts)
    return b"".join(
        (_MAGIC, _LEN.pack(len(payload)), payload, _LEN.pack(zlib.crc32(payload)))
    )


def decode_frame(buf: bytes, off: int = 0) -> Tuple[WalFrame, int]:
    """Decode the frame at ``off``; returns ``(frame, next_offset)``.

    Raises :class:`WalCorruption` on bad magic, a short buffer, or a crc
    mismatch — the caller decides whether that means a torn tail (clean
    stop) or mid-stream damage (policy).
    """
    end = len(buf)
    if off + 8 > end:
        raise WalCorruption(f"short frame header at offset {off}")
    if buf[off : off + 4] != _MAGIC:
        raise WalCorruption(f"bad frame magic at offset {off}")
    (plen,) = _LEN.unpack_from(buf, off + 4)
    if plen > _MAX_PAYLOAD:
        raise WalCorruption(f"implausible payload length {plen} at offset {off}")
    body = off + 8
    if body + plen + 4 > end:
        raise WalCorruption(f"torn frame at offset {off}")
    payload = buf[body : body + plen]
    (crc,) = _LEN.unpack_from(buf, body + plen)
    if zlib.crc32(payload) != crc:
        raise WalCorruption(f"crc mismatch at offset {off}")
    if plen < _FIXED.size:
        raise WalCorruption(f"payload shorter than fixed header at offset {off}")
    version, seq, rows, arity, flags, dtype_len, job_len = _FIXED.unpack_from(
        payload, 0
    )
    if version not in (_FORMAT_VERSION, _SHAPED_VERSION):
        raise WalCorruption(f"unsupported frame version {version} at offset {off}")
    p = _FIXED.size
    dtype_str = payload[p : p + dtype_len].decode("ascii")
    p += dtype_len
    job = payload[p : p + job_len].decode("utf-8")
    p += job_len
    layout = _column_layout(dtype_str, arity, version, off)
    need = p + sum(rows * size * dt.itemsize for dt, _, size in layout)
    need += rows * 4 if flags & _FLAG_IDS else 0
    if need != plen:
        raise WalCorruption(f"frame body size mismatch at offset {off}")
    cols = []
    for dt, shape, size in layout:
        col = np.frombuffer(payload, dt, count=rows * size, offset=p)
        cols.append(col.reshape((rows,) + shape) if shape else col)
        p += rows * size * dt.itemsize
    ids = None
    if flags & _FLAG_IDS:
        ids = np.frombuffer(payload, np.int32, count=rows, offset=p)
    return WalFrame(job, int(seq), tuple(cols), ids), body + plen + 4


def _column_layout(
    dtype_str: str, arity: int, version: int, off: int
) -> List[Tuple[np.dtype, Tuple[int, ...], int]]:
    """``(dtype, per-row shape, values per row)`` of each column of a frame."""
    try:
        if version == _FORMAT_VERSION:
            return [(np.dtype(dtype_str), (), 1)] * arity
        specs = dtype_str.split(",")
        if len(specs) != arity:
            raise ValueError(f"{len(specs)} column specs for arity {arity}")
        out = []
        for spec in specs:
            name, *dims = spec.split("x")
            shape = tuple(int(d) for d in dims)
            out.append((np.dtype(name), shape, int(np.prod(shape, dtype=np.int64))))
        return out
    except (TypeError, ValueError) as err:
        raise WalCorruption(f"bad column layout {dtype_str!r} at offset {off}: {err}")


# ---------------------------------------------------------------------------
# segment reading


def list_segments(directory: str) -> List[str]:
    """Segment paths in seq order (file names sort by first seq)."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    return [
        os.path.join(directory, n)
        for n in sorted(names)
        if n.startswith(_SEGMENT_PREFIX) and n.endswith(_SEGMENT_SUFFIX)
    ]


def read_segment_frames(path: str) -> Iterator[WalFrame]:
    """Yield every frame in one segment; raises WalCorruption where it stops."""
    with open(path, "rb") as fh:
        data = fh.read()
    off = 0
    end = len(data)
    while off < end:
        frame, off = decode_frame(data, off)
        yield frame


def _scan_segment(path: str) -> Tuple[List[WalFrame], int, bool]:
    """Read a segment tolerantly: ``(frames, valid_byte_length, clean)``."""
    with open(path, "rb") as fh:
        data = fh.read()
    frames: List[WalFrame] = []
    off = 0
    end = len(data)
    while off < end:
        try:
            frame, nxt = decode_frame(data, off)
        except WalCorruption:
            return frames, off, False
        frames.append(frame)
        off = nxt
    return frames, off, True


def replay_frames(
    directory: str,
    watermarks: Optional[Mapping[str, int]] = None,
    on_error: str = "raise",
) -> Iterator[WalFrame]:
    """Yield frames past the per-job watermarks, oldest first.

    A decode failure on the **last** segment is treated as a torn tail —
    the remainder was never group-committed, so replay simply stops there.
    Damage anywhere else follows ``on_error`` (mirroring the checkpoint
    restore policies): ``"raise"`` surfaces :class:`WalCorruption`;
    ``"skip_segment"`` abandons the damaged segment wholesale — frames
    decoded before the damage are *not* yielded, since a partially-applied
    segment would break the contiguous-seq dedup contract — counts the
    loss in ``serve.wal_replay_skipped_segments`` /
    ``serve.wal_replay_skipped_rows``, and continues with the next
    segment.
    """
    if on_error not in _REPLAY_POLICIES:
        raise MetricsTPUUserError(
            f"on_error must be one of {_REPLAY_POLICIES}, got {on_error!r}"
        )
    marks = dict(watermarks or {})
    segments = list_segments(directory)
    for idx, path in enumerate(segments):
        last = idx == len(segments) - 1
        frames, _valid, clean = _scan_segment(path)
        if not clean and not last:
            if on_error == "raise":
                raise WalCorruption(
                    f"corrupt frame mid-stream in sealed segment {path}"
                )
            _obs.counter_inc("serve.wal_replay_skipped_segments")
            # the unreadable remainder is counted as a segment-granular loss;
            # rows we cannot decode cannot be counted row-exactly, so the
            # row counter carries what was salvaged alongside the skip
            _obs.counter_inc(
                "serve.wal_replay_skipped_rows", sum(f.rows for f in frames)
            )
            continue
        for frame in frames:
            if frame.seq > marks.get(frame.job, -1):
                yield frame


# ---------------------------------------------------------------------------
# writer


class WalWriter:
    """Per-shard segmented WAL with a dedicated group-commit writer thread.

    ``append`` assigns the next sequence number, encodes the frame under
    the writer mutex (so file order is seq order), and returns a
    :class:`WalTicket`; the caller acks its client only after
    ``ticket.wait()`` confirms the group commit.  All file I/O — writes,
    rotation, fsync — happens on the single writer thread, which batches
    every append queued since the previous flush into one fsync.

    ``fsync=False`` keeps the write+flush pipeline (bytes reach the OS,
    surviving SIGKILL) but skips the disk barrier — the bench sweep uses it
    to price durability, and kill-storm drills are valid either way because
    the page cache outlives the process.
    """

    def __init__(
        self,
        directory: str,
        segment_bytes: int = 4 << 20,
        fsync: bool = True,
    ) -> None:
        if int(segment_bytes) < 1:
            raise MetricsTPUUserError(
                f"segment_bytes must be >= 1, got {segment_bytes}"
            )
        self.directory = directory
        self.segment_bytes = int(segment_bytes)
        self.fsync = bool(fsync)
        os.makedirs(directory, exist_ok=True)
        self._cond = threading.Condition(threading.Lock())
        try:  # named in the runtime lock-witness graph
            self._cond._lock.witness_name = "WalWriter._cond"  # type: ignore[attr-defined]
        except AttributeError:
            pass
        self._pending: List[Tuple[bytes, WalTicket]] = []
        self._stop = False
        self._closed = False
        self._fh = None
        self._active_path: Optional[str] = None
        self._active_size = 0
        self._segment_rows: Dict[str, int] = {}
        self._lag_rows = 0
        self._lag_hwm = 0
        self._next_seq = self._recover()
        self._thread = threading.Thread(
            target=self._run, name=f"wal-writer:{os.path.basename(directory)}",
            daemon=True,
        )
        self._thread.start()

    # -------------------------------------------------------------- recovery
    def _recover(self) -> int:
        """Rebuild next_seq + lag from disk; truncate a torn last-segment tail."""
        next_seq = 0
        segments = list_segments(self.directory)
        for idx, path in enumerate(segments):
            frames, valid, clean = _scan_segment(path)
            if frames:
                next_seq = max(next_seq, frames[-1].seq + 1)
            self._segment_rows[path] = sum(f.rows for f in frames)
            self._lag_rows += self._segment_rows[path]
            if not clean and idx == len(segments) - 1:
                # torn tail: the remainder never group-committed, so no ack
                # covers it — truncate back to the last valid frame
                with open(path, "r+b") as fh:
                    fh.truncate(valid)
                _obs.counter_inc("serve.wal_torn_tails")
            if idx == len(segments) - 1:
                self._active_path = path
                self._active_size = valid
        self._lag_hwm = self._lag_rows
        return next_seq

    # --------------------------------------------------------------- appends
    @property
    def next_seq(self) -> int:
        with self._cond:
            return self._next_seq

    def append(
        self,
        job: str,
        cols: Sequence[np.ndarray],
        stream_ids: Optional[np.ndarray] = None,
    ) -> WalTicket:
        """Queue one frame for the next group commit; returns its ticket.

        Seq assignment, encoding, and enqueue share one critical section so
        the on-disk frame order always equals the assignment order — the
        replay stream must match the ring's ship order bit for bit.
        """
        with self._cond:
            if self._closed:
                raise MetricsTPUUserError("append on a closed WalWriter")
            seq = self._next_seq
            self._next_seq += 1
            encoded = encode_frame(job, seq, cols, stream_ids)
            first = np.asarray(cols[0])
            ticket = WalTicket(seq, int(first.shape[0]) if first.ndim else 1)
            self._pending.append((encoded, ticket))
            self._cond.notify_all()
        return ticket

    def append_wait(
        self,
        job: str,
        cols: Sequence[np.ndarray],
        stream_ids: Optional[np.ndarray] = None,
        timeout: Optional[float] = 30.0,
    ) -> WalTicket:
        """``append`` + block for durability; convenience for tests/tools."""
        ticket = self.append(job, cols, stream_ids)
        ticket.wait(timeout)
        return ticket

    # --------------------------------------------------------- writer thread
    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._stop:
                    self._cond.wait(0.05)
                batch = self._pending
                self._pending = []
                stopping = self._stop
            if batch:
                self._write_group(batch)
                continue
            if stopping:
                return

    def _write_group(self, batch: List[Tuple[bytes, WalTicket]]) -> None:
        rows = sum(t.rows for _, t in batch)
        try:
            for encoded, ticket in batch:
                if self._fh is None or self._active_size >= self.segment_bytes:
                    self._rotate(ticket.seq)
                self._fh.write(encoded)
                self._active_size += len(encoded)
                self._segment_rows[self._active_path] = (
                    self._segment_rows.get(self._active_path, 0) + ticket.rows
                )
            self._fh.flush()
            if self.fsync:
                # the one sanctioned blocking disk barrier in the serve tree:
                # this thread exists so request paths never wait on it directly
                os.fsync(self._fh.fileno())  # analyze: ignore[serve-blocking] -- dedicated WAL writer thread; group commit IS the durability barrier
        except OSError:
            _obs.counter_inc("serve.wal_append_errors", len(batch))
            for _, ticket in batch:
                ticket.ok = False
                ticket._event.set()
            return
        _obs.counter_inc("serve.wal_appends", len(batch))
        _obs.counter_inc("serve.wal_fsyncs")
        _obs.counter_inc("serve.wal_group_commit_rows", rows)
        with self._cond:
            self._lag_rows += rows
            if self._lag_rows > self._lag_hwm:
                # delta counter, ring_occupancy_hwm style: the summed counter
                # IS the high-water mark of durable-but-untruncated rows
                _obs.counter_inc(
                    "serve.wal_lag_rows", self._lag_rows - self._lag_hwm
                )
                self._lag_hwm = self._lag_rows
        for _, ticket in batch:
            ticket.ok = True
            ticket._event.set()

    def _rotate(self, first_seq: int) -> None:
        if self._fh is not None:
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())  # analyze: ignore[serve-blocking] -- writer thread sealing a segment before rotation
            self._fh.close()
        name = f"{_SEGMENT_PREFIX}{first_seq:016d}{_SEGMENT_SUFFIX}"
        self._active_path = os.path.join(self.directory, name)
        self._fh = open(self._active_path, "ab")
        self._active_size = self._fh.tell()
        if self.fsync:
            dir_fd = os.open(self.directory, os.O_RDONLY)
            try:
                os.fsync(dir_fd)  # analyze: ignore[serve-blocking] -- writer thread making the new segment's dirent durable
            finally:
                os.close(dir_fd)

    # ------------------------------------------------------------ truncation
    def truncate_covered(self, watermarks: Mapping[str, int]) -> int:
        """Delete sealed segments whose every frame the watermarks cover.

        ``watermarks`` is the per-job applied-seq map a *committed*
        checkpoint recorded: a frame with ``seq <= watermarks[job]`` is
        already inside the checkpoint, so replay will never need it again.
        The active segment is never deleted (the writer owns its handle).
        Returns the number of segments removed.
        """
        with self._cond:
            active = self._active_path
        removed = 0
        for path in list_segments(self.directory):
            if path == active:
                continue
            frames, _valid, clean = _scan_segment(path)
            if not clean:
                continue  # replay policy owns damaged segments, not GC
            if not frames:
                continue
            if all(f.seq <= watermarks.get(f.job, -1) for f in frames):
                rows = sum(f.rows for f in frames)
                os.remove(path)
                removed += 1
                _obs.counter_inc("serve.wal_truncated_segments")
                with self._cond:
                    self._segment_rows.pop(path, None)
                    self._lag_rows -= rows
        return removed

    def segments(self) -> List[str]:
        return list_segments(self.directory)

    def lag_rows(self) -> int:
        """Durable rows no committed checkpoint's truncation has reclaimed."""
        with self._cond:
            return self._lag_rows

    # ----------------------------------------------------------------- close
    def close(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=10.0)
        if self._fh is not None:
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())  # analyze: ignore[serve-blocking] -- final barrier on close, writer thread already joined
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "WalWriter":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()


# ---------------------------------------------------------------------------
# fault injection (test harness, ChaosStore's sibling)


def inject_wal_fault(path: str, kind: str) -> Dict[str, int]:
    """Damage one segment file in a pinned, deterministic way.

    Kinds (each maps to one recovery policy the tests assert):

    * ``"torn_tail"``  — drop the final 5 bytes, leaving a half-written
      last frame: recovery truncates at the last valid frame boundary.
    * ``"truncate"``   — cut the file mid-way through its *second* frame
      (or mid-first when only one exists): mid-stream damage, policy
      ``raise`` / ``skip_segment`` decides.
    * ``"bit_flip"``   — flip one bit inside the first frame's payload so
      its crc32 no longer matches.

    Returns ``{"offset": ..., "size": ...}`` describing the damage.
    """
    with open(path, "rb") as fh:
        data = fh.read()
    if not data:
        raise MetricsTPUUserError(f"cannot inject into empty segment {path}")
    if kind == "torn_tail":
        cut = max(len(data) - 5, 1)
        with open(path, "r+b") as fh:
            fh.truncate(cut)
        return {"offset": cut, "size": len(data) - cut}
    if kind == "truncate":
        try:
            _, second = decode_frame(data, 0)
        except WalCorruption:
            second = 0
        cut = second + 9 if second + 9 < len(data) else max(len(data) // 2, 1)
        with open(path, "r+b") as fh:
            fh.truncate(cut)
        return {"offset": cut, "size": len(data) - cut}
    if kind == "bit_flip":
        off = 8 + _FIXED.size + 1  # inside the first frame's payload
        if off >= len(data):
            off = len(data) // 2
        flipped = bytes([data[off] ^ 0x40])
        with open(path, "r+b") as fh:
            fh.seek(off)
            fh.write(flipped)
        return {"offset": off, "size": 1}
    raise MetricsTPUUserError(
        f"unknown WAL fault kind {kind!r} (torn_tail|truncate|bit_flip)"
    )
