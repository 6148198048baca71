"""Kernel launch counters of the ops modules.

Each ops module keeps its counters as module-level ints (``A.LAUNCHES``,
``GM.GEMM_LAUNCHES``) that tests, ``chip_smoke.py`` and the benchmark read
and reset.  A module changes them only through its :class:`LaunchCounters`,
which holds one lock (a server launches from several threads at once, and
concurrent ``+=`` can lose counts) and keeps each thread's own running
counts beside the module's: what a CUDA graph captured on a thread
launched is the advance of that thread's counts over the capture, whatever
other threads launch meanwhile (``decode/graphs.py``).  :data:`SETS` holds
every module's set.
"""
from __future__ import annotations

import threading

SETS = []       # every LaunchCounters made, in the order the modules load


class LaunchCounters:
    """The counters ``names`` of a module, kept in its ``namespace`` (the
    module's ``globals()``)."""

    def __init__(self, namespace, names):
        self.namespace = namespace
        self.names = tuple(names)
        self.lock = threading.Lock()
        self._thread = threading.local()
        SETS.append(self)

    def add(self, counts):
        """Add ``counts`` (counter name -> launches) to the counters and to
        the calling thread's own."""
        with self.lock:
            for name, n in counts.items():
                self.namespace[name] += n
        mine = getattr(self._thread, "counts", None)
        if mine is None:
            mine = self._thread.counts = dict.fromkeys(self.names, 0)
        for name, n in counts.items():
            mine[name] += n

    def thread_counts(self):
        """The calling thread's own launches since it started, by counter
        name; :meth:`reset` leaves them as they are."""
        mine = getattr(self._thread, "counts", None)
        return dict(mine or dict.fromkeys(self.names, 0))

    def reset(self):
        """Set every counter to 0."""
        with self.lock:
            for name in self.names:
                self.namespace[name] = 0
