"""The share of the traced test window in which no operation ran on the
card (the window less the union of the device's operation spans), in
percent."""


def read(layers):
    trace = layers.get("trace")
    if trace is None:
        return None
    return 100.0 * (trace.window_s - trace.busy_s) / trace.window_s
