"""Cross-client request coalescing for the serving path: the port's own
copy of ``subgc_tpu/utils/microbatch.py`` (pure Python, held to the same
cases as ``tests/test_microbatch.py`` by
``tests/test_torch_port_microbatch.py``).

The service pads every dispatch to a fixed batch of images, so each
dispatch costs the same whether 1 or ``max_batch`` images ride it, and its
GEMM and kernel shapes stay fixed.  The reference never serves online (its
`eval_utils.py` only walks offline splits); for an endpoint the win is
coalescing: concurrent single-image HTTP requests should share one
dispatch instead of serializing ``max_batch``-padded dispatches behind a
device lock.

Leader-election design (no background thread):

* callers enqueue their items and wait on a shared condition variable
* the first idle waiter elects itself leader, waits up to ``max_wait_ms``
  for the queue to fill (returning immediately once ``max_batch`` items are
  queued), then runs ``run_batch`` on up to ``max_batch`` items *outside*
  the lock and distributes results
* everyone whose item rode that dispatch wakes up with a result; anyone
  left re-runs the election

Per-item results must be independent of batch composition for this to be
transparent — true here because every image of a dispatch is decoded on its
own rows at fixed shapes and padding slots are discarded.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Sequence

_UNSET = object()


class QueueFull(RuntimeError):
    """Raised by submit/submit_many when admission would push the queue past
    ``max_queue`` — the caller (e.g. the HTTP layer) turns this into load
    shedding (429) instead of letting every client's latency grow without
    bound."""

    def __init__(self, load: int, max_queue: int):
        super().__init__(f"micro-batch queue full ({load} queued/in-flight "
                         f">= cap {max_queue})")
        self.load = load
        self.max_queue = max_queue


class AdaptiveWait:
    """Fill-window policy tuned from the observed arrival rate.

    The fixed window wastes latency when traffic is sparse (waiting for
    stragglers that will not come) and under-fills when the window is
    shorter than the time to accumulate ``max_batch`` arrivals.  This
    policy keeps an EWMA of request inter-arrival gaps and waits
    ``headroom x remaining_slots x mean_gap``, capped at ``max_wait_ms`` —
    i.e. exactly long enough for the batch to plausibly fill, and ~zero
    when arrivals are so sparse that filling is hopeless within the cap.
    """

    def __init__(self, max_wait_ms: float = 25.0, alpha: float = 0.2,
                 headroom: float = 1.5):
        self.max_s = max_wait_ms / 1000.0
        self.alpha = alpha
        self.headroom = headroom
        self.mean_gap = None            # EWMA inter-arrival seconds
        self._last = None

    def observe_arrivals(self, n: int = 1):
        now = time.monotonic()
        if self._last is not None and n > 0:
            gap = (now - self._last) / n
            self.mean_gap = (gap if self.mean_gap is None
                             else (1 - self.alpha) * self.mean_gap
                             + self.alpha * gap)
        self._last = now

    def wait_s(self, queued: int, max_batch: int) -> float:
        if queued >= max_batch:
            return 0.0
        if self.mean_gap is None:
            return self.max_s          # cold start: behave like the cap
        # wait just long enough for the batch to plausibly fill, capped.
        # An earlier variant of the JAX package returned a minimal beat when
        # est > cap ("filling is hopeless, dispatch now"); on its device it
        # cratered mid-rate closed-loop traffic: underfull dispatches
        # serialize behind the device dispatch, and with closed-loop
        # clients the observed gap overestimates true sparsity (arrivals
        # pause while clients wait for results).  Waiting the cap costs at
        # most max_wait_ms of latency, small against the dispatch itself.
        return min(self.headroom * (max_batch - queued) * self.mean_gap,
                   self.max_s)


class MicroBatcher:
    """Coalesce concurrent ``submit`` calls into ``run_batch`` dispatches.

    run_batch: items (1..max_batch of them) -> list of per-item results,
    same length/order.  Exceptions propagate to every caller in the batch.

    adaptive=True replaces the fixed fill window with :class:`AdaptiveWait`
    (max_wait_ms becomes its cap).

    max_queue > 0 bounds queue pressure (queued items plus one in-flight
    batch): a submit that would exceed it raises :class:`QueueFull`
    immediately instead of joining an unboundedly growing line.  0 keeps
    the historical unbounded behavior.
    """

    def __init__(self, run_batch: Callable[[List], List], max_batch: int,
                 max_wait_ms: float = 3.0, adaptive: bool = False,
                 max_queue: int = 0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_queue and max_queue < max_batch:
            raise ValueError(f"max_queue ({max_queue}) must be >= max_batch "
                             f"({max_batch}) or 0 (unbounded)")
        self._run = run_batch
        self._max = max_batch
        self._wait_s = max_wait_ms / 1000.0
        self._adaptive = AdaptiveWait(max_wait_ms) if adaptive else None
        self._max_queue = int(max_queue)  # 0 = unbounded
        self._cv = threading.Condition()
        self._queue: List[list] = []     # [item, result, error] cells
        self._busy = False
        self.dispatch_count = 0          # observability (tests/metrics)
        self.item_count = 0              # total items across dispatches
        self.shed_count = 0              # items refused by the queue cap

    def load(self) -> int:
        """Instantaneous queue pressure: queued items, plus a full batch
        when a dispatch is in flight.  Used by least-loaded routing across
        replicas (cli/serve.py::_ReplicaSet)."""
        with self._cv:
            return len(self._queue) + (self._max if self._busy else 0)

    def submit(self, item):
        return self.submit_many([item])[0]

    def submit_many(self, items: Sequence):
        """Enqueue all items at once (they coalesce with other callers'),
        block until every one has a result."""
        cells = [[it, _UNSET, None] for it in items]
        cv = self._cv
        with cv:
            if self._max_queue:
                # admission control is all-or-nothing per call: shedding a
                # request's tail items while serving its head would hand the
                # caller a partial result
                load = len(self._queue) + (self._max if self._busy else 0)
                if load + len(cells) > self._max_queue:
                    self.shed_count += len(cells)
                    raise QueueFull(load, self._max_queue)
            if self._adaptive is not None:
                self._adaptive.observe_arrivals(len(cells))
            self._queue.extend(cells)
            cv.notify_all()
            while any(c[1] is _UNSET and c[2] is None for c in cells):
                if self._busy or not self._queue:
                    cv.wait(0.05)
                    continue
                # leader: give stragglers time to fill the batch — a fixed
                # window, or the arrival-rate-tuned adaptive one
                wait_s = (self._adaptive.wait_s(len(self._queue), self._max)
                          if self._adaptive is not None else self._wait_s)
                deadline = time.monotonic() + wait_s
                while (not self._busy
                       and 0 < len(self._queue) < self._max):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    cv.wait(remaining)
                # re-check under the lock after waiting: another leader may
                # have started dispatching or drained the queue (possibly
                # resolving our cells — the outer while notices)
                if self._busy or not self._queue:
                    continue
                batch = self._queue[:self._max]
                del self._queue[:len(batch)]
                self._busy = True
                self.dispatch_count += 1
                self.item_count += len(batch)
                cv.release()
                results, err = None, None
                try:
                    results = self._run([c[0] for c in batch])
                    if len(results) != len(batch):
                        raise RuntimeError(
                            f"run_batch returned {len(results)} results "
                            f"for {len(batch)} items")
                except Exception as e:
                    err, results = e, None
                finally:
                    cv.acquire()
                    self._busy = False
                    for i, cell in enumerate(batch):
                        if results is not None:
                            cell[1] = results[i]
                        else:
                            cell[2] = err if err is not None else \
                                RuntimeError("batch aborted")
                    cv.notify_all()
        for c in cells:
            if c[2] is not None:
                raise c[2]
        return [c[1] for c in cells]
