"""Milliseconds a training step takes (``train/step.py``), from the
benchmark's span around the step call, synchronised with the card at both
ends."""


def read(layers):
    n = layers.get("spans_steps")
    if not n or "step" not in layers.get("span_s", {}):
        return None
    return layers["span_s"]["step"] / n * 1e3
