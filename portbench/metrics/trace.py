"""Reading a ``torch.profiler`` trace of the card: the device's busy time
as the union of its operations' spans, time by kernel name, and the idle
gaps labelled by what the host was doing.

The benchmark marks its traced window with the annotation
``portbench.window`` and the layers it enters with ``portbench.<layer>``
annotations; those name the host's activity in a gap.
"""
from __future__ import annotations

import numpy as np
from torch.autograd import DeviceType

WINDOW = "portbench.window"


class NoDeviceWork(RuntimeError):
    """The trace holds no operation that ran on the card."""


class Trace:
    def __init__(self, prof):
        dev, cpu = [], []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            span = (e.start_ns(), e.start_ns() + e.duration_ns())
            if e.device_type() == DeviceType.CUDA:
                # kernels, copies and fills; not the benchmark's annotations
                # that the profiler mirrors onto the device's timeline
                if not name.startswith("portbench."):
                    dev.append((name,) + span)
            else:
                cpu.append((name,) + span)
        windows = [c for c in cpu if c[0] == WINDOW]
        if not windows:
            raise RuntimeError(f"the trace holds no {WINDOW} annotation")
        self.t0, self.t1 = windows[0][1], windows[0][2]
        self.window_s = (self.t1 - self.t0) * 1e-9
        dev = [d for d in dev if d[2] > self.t0 and d[1] < self.t1]
        if not dev:
            raise NoDeviceWork(
                "the profiler's trace of the card holds no kernel, copy or "
                "fill in the traced window: device metrics cannot be read")
        self.dev = dev
        self.cpu = [c for c in cpu if c[0] != WINDOW]
        self._merge()

    def _merge(self):
        spans = sorted((max(s, self.t0), min(e, self.t1))
                       for _, s, e in self.dev)
        merged = [list(spans[0])]
        for s, e in spans[1:]:
            if s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.merged = merged
        self.busy_s = sum(e - s for s, e in merged) * 1e-9

    def time_of(self, *parts):
        """Summed device seconds of the operations whose name holds any of
        ``parts``."""
        return sum(e - s for n, s, e in self.dev
                   if any(p in n for p in parts)) * 1e-9

    def device_ops(self, top=10):
        by = {}
        for n, s, e in self.dev:
            by[n] = by.get(n, 0) + (e - s) * 1e-9
        return sorted(([n[:200], t] for n, t in by.items()),
                      key=lambda x: -x[1])[:top]

    def idle_gaps(self, top=10, examined=200):
        """The longest idle gaps of the window (at most ``examined``),
        their seconds summed by what the host was doing at each gap's
        middle: the innermost ``portbench.`` annotation (the layer) and
        the innermost operation then running."""
        edges = [self.t0] + [x for se in self.merged for x in se] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:examined]
        if not self.cpu or not gaps:
            return []
        names = [c[0] for c in self.cpu]
        starts = np.array([c[1] for c in self.cpu], np.int64)
        ends = np.array([c[2] for c in self.cpu], np.int64)
        ann = np.array([c[0].startswith("portbench.") for c in self.cpu])
        by = {}
        for s, e in gaps:
            mid = (s + e) // 2
            on = np.nonzero((starts <= mid) & (ends >= mid))[0]
            outer = [i for i in on if ann[i]]
            inner = [i for i in on if not ann[i]]
            label = (names[max(outer, key=lambda i: starts[i])]
                     if outer else "outside the layers")
            if inner:
                label += "/" + names[max(inner, key=lambda i: starts[i])]
            by[label] = by.get(label, 0) + (e - s) * 1e-9
        return sorted(([k[:200], v] for k, v in by.items()),
                      key=lambda x: -x[1])[:top]
