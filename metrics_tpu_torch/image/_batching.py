"""Host-side image-batch accumulation for the extractor-backed metrics
(counterpart of ``metrics_tpu/image/_batching.py``).

FID, KID, IS and LPIPS fold per-image (or per-pair) reductions, so they may
queue incoming images and run their extractor at a chunk size of the caller's
choice (``extractor_batch``) without changing any result.  Metrics mix in
:class:`ChunkedExtractorMixin`, call ``_init_chunking`` in ``__init__``, route
updates through ``_push_or_ingest`` and implement ``_ingest_chunk(key, imgs)``.
While images wait in the queue the metric's states are held
(:meth:`Metric._hold_states`), so every read surface, a direct state read
included, drains the queue first.
"""

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch


class ChunkedImageQueue:
    """Per-key queues drained in chunks of exactly ``chunk`` rows; a partial last
    chunk only on :meth:`drain`.  One concatenation per drain (``torch.cat``, or
    ``np.concatenate`` when every batch is a numpy array), so large pushes stay
    linear in bytes copied.  Tensors are queued as they are; numpy batches are
    copied at push, since loaders reuse their buffers and a later drain must see
    the values of the call."""

    def __init__(self, chunk: int) -> None:
        self.chunk = int(chunk)
        self._bufs: Dict[Any, List[Union[torch.Tensor, np.ndarray]]] = {}

    def push(self, key: Any, imgs: Any) -> List[Any]:
        """Queue a batch; returns the chunks it completed."""
        if isinstance(imgs, np.ndarray):
            imgs = np.array(imgs, copy=True)
        elif not isinstance(imgs, torch.Tensor):
            imgs = np.asarray(imgs)
        if imgs.shape[0] == 0:
            return []  # an empty batch must not leave the queue pending
        self._bufs.setdefault(key, []).append(imgs)
        return self._take(key, partial=False)

    def drain(self, key: Any) -> List[Any]:
        """Empty the queue of ``key`` (the last chunk may be partial)."""
        return self._take(key, partial=True)

    def _take(self, key: Any, partial: bool) -> List[Any]:
        buf = self._bufs.get(key, [])
        total = sum(b.shape[0] for b in buf)
        if total == 0:
            self._bufs[key] = []
            return []
        if not partial and total < self.chunk:
            return []
        if len(buf) == 1:
            cat = buf[0]
        elif all(isinstance(b, np.ndarray) for b in buf):
            cat = np.concatenate(buf, axis=0)
        else:
            device = next(b.device for b in buf if isinstance(b, torch.Tensor))
            cat = torch.cat([torch.as_tensor(b, device=device) for b in buf], dim=0)
        out, off = [], 0
        while total - off >= self.chunk:
            out.append(cat[off : off + self.chunk])
            off += self.chunk
        if partial and off < total:
            out.append(cat[off:])
            off = total
        self._bufs[key] = [cat[off:]] if off < total else []
        return out

    @property
    def pending(self) -> bool:
        return any(len(b) for b in self._bufs.values())

    def keys(self) -> List[Any]:
        return list(self._bufs)

    def clear(self) -> None:
        self._bufs = {}


class ChunkedExtractorMixin:
    """Metric mixin wiring a :class:`ChunkedImageQueue` into the read-flush
    protocol.  Subclasses implement ``_ingest_chunk(key, imgs)``.

    The extractor's weights are not states: they stay out of the states, the
    checkpoints and the sync payload, and move with :meth:`to_device`."""

    def _init_chunking(self, extractor_batch: Optional[int]) -> None:
        self.extractor_batch = extractor_batch
        self._queue: Optional[ChunkedImageQueue] = ChunkedImageQueue(extractor_batch) if extractor_batch else None
        self._flushing_images = False

    def _ingest_chunk(self, key: Any, imgs: Any) -> None:
        raise NotImplementedError

    def _push_or_ingest(self, key: Any, imgs: Any) -> None:
        if self._queue is None or self._state_swapped:
            self._ingest_chunk(key, imgs)
            return
        # the ingest's state reads reach __getattr__, whose flush is what runs here already
        self._flushing_images = True
        try:
            for chunk in self._queue.push(key, imgs):
                self._ingest_chunk(key, chunk)
        finally:
            self._flushing_images = False
        if self._queue.pending:
            self._hold_states()

    def _flush_host_buffers(self) -> None:
        super()._flush_host_buffers()  # the base's pending host sums
        if self._queue is None or self._flushing_images or self._state_swapped:
            return
        self._flushing_images = True
        try:
            for key in self._queue.keys():
                for chunk in self._queue.drain(key):
                    self._ingest_chunk(key, chunk)
        finally:
            self._flushing_images = False

    def _drain_real_before_reset(self) -> None:
        """Fold the queued *real* images in before a reset that keeps the real statistics
        (the fake images belong to the cleared epoch and go with it)."""
        if self.reset_real_features or self._queue is None:
            return
        self._flushing_images = True
        try:
            for chunk in self._queue.drain(True):
                self._ingest_chunk(True, chunk)
        finally:
            self._flushing_images = False

    def _reset_chunking(self) -> None:
        if self._queue is not None:
            self._queue.clear()

    def to_device(self, device: Union[str, torch.device]) -> Any:
        out = super().to_device(device)
        for holder in (getattr(self, "extractor", None), getattr(self, "_net", None)):
            if hasattr(holder, "to"):
                holder.to(self.device)
        return out
