"""Host-side input pipeline: batch assembly and the copy to the card on a
producer thread.

The counterpart of ``subgc_tpu/data/prefetch.py`` (which replaces the
reference's ``BlobFetcher`` process pool with pinned memory,
`dataloaders/dataloader.py:392-476`): a thread assembles the next batches
while the current step runs, ``depth`` ahead.  On a CUDA device the thread
copies each batch from pinned host memory without blocking, on a stream of
the prefetcher's own, and records an event after the copy; the consumer's
stream waits on that event before the step reads the batch, and each
tensor is marked as used on the consumer's stream (``record_stream``), so
that neither a half-copied batch is read nor its memory handed out again
while the step still reads it.  On the CPU it is the same thread with no
stream.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

import torch

from ..utils.profiling import span


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


class BatchPrefetcher:
    """Wrap a ``get_batch`` callable with background assembly and transfer.

    ``get_batch() -> (host_batch, *aux)``; ``place(host_batch)`` moves the
    batch to ``device`` (on a CUDA device: pinned, ``non_blocking`` copies
    on the stream current when it is called, which is the prefetcher's).
    :meth:`next` returns ``(device_batch, aux)`` in ``get_batch``'s order
    and raises a failure of the producer thread.  Call :meth:`stop` on every
    exit path.
    """

    def __init__(self, get_batch: Callable, depth: int = 2,
                 place: Optional[Callable] = None, device="cpu"):
        self.get_batch = get_batch
        self.place = place or (lambda batch: batch)
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc = None
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _put(self, item) -> bool:
        """Block until there is room (the bounded depth) or a stop."""
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            while not self._stop.is_set():
                item = self.get_batch()
                batch, aux = item[0], item[1:]
                event = None
                if self.stream is not None:
                    with torch.cuda.stream(self.stream):
                        dev = self.place(batch)
                        event = torch.cuda.Event()
                        event.record(self.stream)
                else:
                    dev = self.place(batch)
                if not self._put((dev, event, aux)):
                    return
        except Exception as e:    # surface worker failures to the consumer
            self._exc = e
            self._put(None)

    def next(self):
        with span("subgc.train.next_batch"):
            item = self.q.get()
            if item is None:
                raise RuntimeError("prefetch worker failed") from self._exc
            dev, event, aux = item
            if event is not None:
                consumer = torch.cuda.current_stream(self.device)
                consumer.wait_event(event)
                for t in _tensors(dev):
                    t.record_stream(consumer)
            return dev, aux

    def stop(self, timeout: float = 60.0):
        """Stop the producer: drain the queue so a blocked put returns, and
        join the thread (it finishes the batch it is assembling)."""
        self._stop.set()
        while self.thread.is_alive():
            try:
                while True:
                    self.q.get_nowait()
            except queue.Empty:
                pass
            self.thread.join(timeout=0.1)
            timeout -= 0.1
            if timeout <= 0:
                break
