"""What the program records of itself, laid over the trace: its spans
(``subgc_tpu_torch.utils.profiling.recorded_spans``), kept while the
profiler records and stamped on the clock the profiler stamps its host
events with, clipped to the traced window; the device's busy intervals
(``Trace.merged``); and the runtime calls of the trace's host events
(``Trace.cpu``), counted by the span their start falls in.

A program that records no spans (one older than its span recorder) gives
nothing to read: every reader returns None."""
from __future__ import annotations

import numpy as np

PREFIX = "subgc."
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")


def spans(layers):
    """The program's spans that overlap the traced window, clipped to it:
    (name, start_ns, end_ns); None without a trace or a span recorder."""
    trace = layers.get("trace")
    if trace is None:
        return None
    try:
        from subgc_tpu_torch.utils.profiling import recorded_spans
    except ImportError:
        return None
    return [(r.name, max(r.start_ns, trace.t0), min(r.end_ns, trace.t1))
            for r in recorded_spans()
            if r.end_ns >= trace.t0 and r.start_ns <= trace.t1]


def union(intervals):
    """Sorted disjoint intervals covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(a, b):
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def ms_per(layers, names, per):
    """Milliseconds of the spans named in ``names`` per span named
    ``per``; None where the window holds none of either."""
    sp = spans(layers)
    if not sp:
        return None
    n = sum(1 for name, _, _ in sp if name == per)
    inside = [e - s for name, s, e in sp if name in names]
    if not n or not inside:
        return None
    return sum(inside) / n * 1e-6


def count_per(layers, name, per):
    """Spans named ``name`` per span named ``per``; None where the window
    holds none of either."""
    sp = spans(layers)
    if not sp:
        return None
    n = sum(1 for x in sp if x[0] == per)
    k = sum(1 for x in sp if x[0] == name)
    return k / n if n and k else None


def calls_per(layers, calls, within, per):
    """Runtime calls named in ``calls`` that start inside a span named
    ``within``, per span named ``per``; None where the window holds none
    of either span."""
    sp = spans(layers)
    if not sp:
        return None
    n = sum(1 for x in sp if x[0] == per)
    inside = union([(s, e) for name, s, e in sp if name == within])
    if not n or not inside:
        return None
    starts = np.sort(np.array([c[1] for c in layers["trace"].cpu
                               if c[0] in calls], np.int64))
    edges = np.array(inside, np.int64)
    hits = (np.searchsorted(starts, edges[:, 1])
            - np.searchsorted(starts, edges[:, 0]))
    return float(hits.sum()) / n


def idle_unspanned_pct(layers, marker):
    """The window's idle time (the window less the union of the device's
    operations) that no program span covers, as a percent of all idle
    time; None where the window holds no span named ``marker``."""
    sp = spans(layers)
    if not sp or not any(name == marker for name, _, _ in sp):
        return None
    trace = layers["trace"]
    edges = [trace.t0] + [x for se in trace.merged for x in se] + [trace.t1]
    idle = [[edges[i], edges[i + 1]] for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    total = sum(e - s for s, e in idle)
    if total <= 0:
        return 0.0
    covered = union([(s, e) for name, s, e in sp if name.startswith(PREFIX)])
    return 100.0 * (total - overlap(idle, covered)) / total
