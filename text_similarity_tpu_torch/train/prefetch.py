"""Device-prefetching batch pipeline (port of
``text_similarity_tpu.train.prefetch``).

A background thread stays ``depth`` batches ahead of the training loop: it
turns each host batch (a dict of numpy arrays) into pinned tensors and
copies them to the card on a side stream, so a step dequeues data that is
already resident. On the CPU it only converts. With ``mesh`` each batch is
split over the mesh's data positions (``train.steps.shard_batch_for``): a
list of per-position dicts, each on its position's device.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from ..core.precision import resolve_device


class DevicePrefetcher:
    """Iterate host batches with their copies overlapped ``depth`` ahead.

    Exceptions in the producer propagate to the consumer; iteration is
    single-use (wrap a fresh iterator per epoch); ``close()`` stops the
    producer and drops the queued batches."""

    _END = object()

    def __init__(self, batches: Iterable, depth: int = 2, device="cuda", mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._thread = threading.Thread(target=self._produce, args=(iter(batches),), daemon=True)
        self._thread.start()

    def _place(self, batch: dict):
        host = {
            k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            for k, v in batch.items()
        }
        if self.mesh is not None:
            from .steps import shard_batch_for

            # pageable host memory: each copy has finished when it returns
            return shard_batch_for(self.mesh, host)
        if self._stream is None:
            return {k: v.to(self.device) for k, v in host.items()}
        with torch.cuda.stream(self._stream):
            out = {
                k: (v.pin_memory() if not v.is_cuda else v).to(self.device, non_blocking=True)
                for k, v in host.items()
            }
        self._stream.synchronize()   # the batch is whole before the consumer sees it
        return out

    def _put(self, item) -> bool:
        """A blocking put that gives up when close() is asked for (a plain
        put would block the producer forever once the consumer stops)."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, it: Iterator) -> None:
        try:
            for b in it:
                if self._stop.is_set() or not self._put(self._place(b)):
                    return
            self._put(self._END)
        except BaseException as e:   # handed to the consumer
            self._put(e)
            self._put(self._END)     # later next() calls end instead of blocking

    def close(self) -> None:
        """Stop the producer and drop the queued batches. Idempotent; the
        Trainer calls it in a ``finally``."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get_nowait()   # unblock a pending put
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is self._END:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        if self._stream is not None and self.mesh is None:
            # made on the side stream, used on the consumer's: the caching
            # allocator must not hand the memory back before that use ends
            current = torch.cuda.current_stream(self.device)
            for t in item.values():
                t.record_stream(current)
        return item
