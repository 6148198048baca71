"""Tracing and profiling utilities.

The counterpart of ``subgc_tpu/utils/profiling.py``.  The reference's only
observability is wall-clock prints every 5 iterations with explicit CUDA
synchronizes (`train.py:134-174`); here: phase timers with summary
statistics, spans at the program's layer boundaries, and a context manager
around ``torch.profiler`` that writes a Chrome trace and the spans.

Spans (:func:`span`) are recorded only while a ``torch.profiler`` is
recording on the calling thread, into a bounded buffer in memory
(:func:`recorded_spans`), and stamped with ``time.time_ns()``: the clock
the profiler stamps its host events with, and onto which it converts the
device's timestamps, so that spans and trace lie over each other.  They are
not ``record_function`` annotations: the profiler mirrors each of those onto
the device's timeline as an annotation spanning its kernels, which a reader
of the device's busy time would count as work, and each one enters the
profiler's machinery even with no profiler running.  With none running, a
span is one check of the profiler's state and a shared no-op context.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, NamedTuple

from torch.autograd import _profiler_enabled

SPAN_CAP = 1 << 18             # records kept: the newest


class SpanRecord(NamedTuple):
    """One span: its name, start and end (``time.time_ns()``), the index of
    its enclosing span in the same list (-1: none recorded, or dropped) and
    the thread that ran it."""
    name: str
    start_ns: int
    end_ns: int
    parent: int
    thread: int


_NO_SPAN = contextlib.nullcontext()
_SPANS = deque(maxlen=SPAN_CAP)
_SEQ = itertools.count()
_OPEN = threading.local()      # per thread: the open spans' numbers


class _Span:
    __slots__ = ("name", "seq", "parent", "start")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.parent = stack[-1] if stack else -1
        self.seq = next(_SEQ)
        stack.append(self.seq)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _OPEN.stack.pop()
        # one append: atomic under the interpreter lock
        _SPANS.append((self.seq, self.name, self.start, end, self.parent,
                       threading.get_ident()))
        return False


def span(name: str):
    """A context manager that records the block as a span named ``name``
    while a ``torch.profiler`` records on this thread; otherwise one
    shared no-op context (no clock read, no allocation)."""
    if not _profiler_enabled():
        return _NO_SPAN
    return _Span(name)


def recorded_spans() -> List[SpanRecord]:
    """The spans closed so far (the newest :data:`SPAN_CAP`), in the order
    they opened, each parent an index into the returned list."""
    rows = sorted(_SPANS)
    at = {r[0]: i for i, r in enumerate(rows)}
    return [SpanRecord(name, start, end, at.get(parent, -1), thread)
            for _, name, start, end, parent, thread in rows]


def clear_spans() -> None:
    _SPANS.clear()


class PhaseTimers:
    """Accumulating named timers (host wall-clock)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time a block; with ``sync`` (a device) the block's device work
        is waited for and counted (``torch.cuda.synchronize`` on a CUDA
        device; on the CPU the work is done when the block returns)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                import torch
                if torch.device(sync).type == "cuda":
                    torch.cuda.synchronize(sync)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {k: {"total_s": round(self.totals[k], 4),
                    "count": self.counts[k],
                    "mean_ms": round(1e3 * self.totals[k]
                                     / max(self.counts[k], 1), 3)}
                for k in sorted(self.totals)}

    def report(self) -> str:
        lines = [f"{k:>24}: {v['total_s']:8.2f}s / {v['count']:6d} = "
                 f"{v['mean_ms']:8.2f}ms" for k, v in self.summary().items()]
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` (CPU, and CUDA where a card is present) around a
    block; writes ``<logdir>/trace.json``, a Chrome trace (chrome://tracing
    or Perfetto), and ``<logdir>/spans.json``, the spans recorded under it
    (:class:`SpanRecord` fields, parents indexing that list; times on the
    trace's clock).  Yields the trace file's path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    with profile(activities=activities) as prof:
        t0 = time.time_ns()
        try:
            yield path
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    spans = recorded_spans()
    first = next((i for i, r in enumerate(spans) if r.start_ns >= t0),
                 len(spans))
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump([dict(r._asdict(), parent=max(r.parent - first, -1))
                   for r in spans[first:]], f)
