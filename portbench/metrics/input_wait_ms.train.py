"""Milliseconds a training step waits for its batch
(``data/prefetch.py::BatchPrefetcher.next``), from the benchmark's span
around that call."""


def read(layers):
    n = layers.get("spans_steps")
    if not n or "input_wait" not in layers.get("span_s", {}):
        return None
    return layers["span_s"]["input_wait"] / n * 1e3
