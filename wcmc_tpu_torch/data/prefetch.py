"""Host -> device batch prefetching on a CUDA stream of its own.

Counterpart of ``wcmc_tpu/data/prefetch.py``.  A producer thread runs
the host loader (patch cutting, collation), copies each batch into
pinned host memory and from there to the device on a side stream, and
records an event after the copies.  The consumer's stream waits on that
event before the batch is used, and every tensor is ``record_stream``-ed
on the consumer's stream, so the caching allocator does not hand its
memory out again while the consumer's work on it is still queued.  On a
CPU device the same code runs without streams or pinning.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

_SENTINEL = object()


def host_tensor(v) -> torch.Tensor:
    """A host numpy array (or tensor) as a CPU tensor, without a copy.
    bfloat16 arrays (``ml_dtypes.bfloat16``, which numpy and torch do
    not share) go through their 16-bit pattern."""
    if isinstance(v, torch.Tensor):
        return v
    v = np.asarray(v)
    if v.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(v).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(v))


class DevicePrefetcher:
    """Wrap a host batch iterable; yields batches of tensors on
    ``device`` (the card unless given).

    ``depth`` is the number of batches kept in flight (2 = classic
    double buffering).  An exception raised by the loader reaches the
    consumer at its next ``next()``; a consumer that stops early stops
    the producer too."""

    def __init__(self, loader: Iterable[dict], depth: int = 2, device=None):
        from wcmc_tpu_torch.utils.utils import resolve_device

        self.loader = loader
        self.depth = depth
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())

    def __len__(self):
        return len(self.loader)

    def _put_cpu(self, batch: dict) -> dict:
        return {k: host_tensor(v).to(self.device) for k, v in batch.items()}

    def _put_cuda(self, batch: dict, stream) -> tuple:
        with torch.cuda.stream(stream):
            out = {k: host_tensor(v).pin_memory().to(self.device, non_blocking=True)
                   for k, v in batch.items()}
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def __iter__(self) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                if cuda:
                    torch.cuda.set_device(self.device)
                for batch in self.loader:
                    item = self._put_cuda(batch, stream) if cuda else (self._put_cpu(batch), None)
                    if not put(item):
                        return
            except BaseException as e:  # noqa: BLE001 — relayed to the consumer
                put(e)
                return
            put(_SENTINEL)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    break
                if isinstance(item, BaseException):
                    raise item
                batch, event = item
                if event is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(event)
                    for v in batch.values():
                        v.record_stream(consumer)
                yield batch
        finally:
            stop.set()
            t.join()
