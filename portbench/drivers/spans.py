"""Spans the benchmark records around the program's layers, from its own
code: a wrapper put in place of a module's function for the traced run,
synchronised with the card at both ends, and named for the profiler."""
from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ..metrics.trace import WINDOW, Trace


class Spans:
    """Seconds and calls per layer; counted only while ``counting``."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.seconds = {}
        self.calls = {}
        self.counting = False
        self._undo = []

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, layer, sync=True):
        with record_function("portbench." + layer):
            if sync:
                self._sync()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if sync:
                    self._sync()
                if self.counting:
                    dt = time.perf_counter() - t0
                    self.seconds[layer] = self.seconds.get(layer, 0.0) + dt
                    self.calls[layer] = self.calls.get(layer, 0) + 1

    def wrap(self, module, attr, layer, sync=True):
        """Put a spanned wrapper in place of ``module.attr`` (undone by
        :meth:`restore`)."""
        fn = getattr(module, attr)

        def wrapped(*a, **k):
            with self.span(layer, sync):
                return fn(*a, **k)

        setattr(module, attr, wrapped)
        self._undo.append((module, attr, fn))

    def restore(self):
        for module, attr, fn in reversed(self._undo):
            setattr(module, attr, fn)
        self._undo.clear()


@contextlib.contextmanager
def profiled(device):
    """``torch.profiler`` over the block, its window marked; yields a list
    that holds the :class:`Trace` once the block has ended."""
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = []
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield out
            if cuda:
                torch.cuda.synchronize()
    out.append(Trace(prof))
