"""Milliseconds a dispatch spends in the decode (``decode/beam.py::
beam_search`` or ``decode/greedy.py::sample``), from the benchmark's
synchronised span around it."""


def read(layers):
    n = layers.get("spans_dispatches")
    if not n or "decode" not in layers.get("span_s", {}):
        return None
    return layers["span_s"]["decode"] / n * 1e3
