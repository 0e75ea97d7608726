"""Batch loader with background prefetch (port of ``repro.data.loader``).

Wraps a host iterator of batches (dicts of numpy arrays or tensors); a
thread places each batch on ``device`` ahead of the consumer, so host
generation and the copy to the card overlap the training step.  On a CUDA
device each array goes to a pinned host tensor first and then to the card
with ``non_blocking=True`` on a side stream, which the thread waits for
before it hands the batch over; the consumer's stream is recorded on each
tensor, so the allocator does not reuse its memory under a running step (the
JAX package places batches on a mesh with the step's sharding; one card
needs only the device).  ``close()`` stops
the thread and joins it, also while it is blocked on a full queue.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Iterator

import numpy as np
import torch


class ShardedLoader:
    def __init__(self, it: Iterator, device="cuda", prefetch: int = 2):
        self.it = it
        self.device = torch.device(device)
        self.q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _place_one(self, x):
        t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) \
            else torch.as_tensor(x)
        if self.device.type == "cuda":
            with torch.cuda.stream(self._stream):
                return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _place(self, batch):
        if isinstance(batch, dict):
            placed = {k: self._place_one(v) for k, v in batch.items()}
        else:
            placed = self._place_one(batch)
        if self._stream is not None:
            self._stream.synchronize()       # the batch is whole on the card
        return placed

    def _worker(self):
        try:
            for batch in self.it:
                if self._stop.is_set():
                    return
                placed = self._place(batch)
                # A bare q.put would deadlock on close(): with the consumer
                # gone and the queue full it blocks forever, so the stop
                # event is re-checked between bounded put attempts.
                while not self._stop.is_set():
                    try:
                        self.q.put(placed, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        finally:
            # the end marker waits for room as a batch does: dropped on a full
            # queue (as the JAX loader drops it), a finite stream would leave
            # its consumer blocked after the last batch
            while not self._stop.is_set():
                try:
                    self.q.put(None, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():          # closed loaders yield nothing
            raise StopIteration
        item = self.q.get()
        if item is None:
            raise StopIteration
        if self._stream is not None:
            consumer = torch.cuda.current_stream(self.device)
            for t in (item.values() if isinstance(item, dict) else [item]):
                t.record_stream(consumer)
        return item

    def close(self, timeout: float = 5.0) -> None:
        """Stop the prefetch thread and join it (safe with a full queue)."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        while self.thread.is_alive() and time.monotonic() < deadline:
            # drain so a put blocked on a full queue wakes and sees the stop
            try:
                self.q.get_nowait()
            except queue.Empty:
                pass
            self.thread.join(timeout=0.05)
        # wake any consumer still blocked in __next__'s q.get()
        try:
            self.q.put_nowait(None)
        except queue.Full:
            pass
