"""The training step's share of the card's float32 peak over the traced
window: the operations the window's steps need (``counts.train_step``,
forward and backward) over the window, over 67 TFLOP/s, in percent."""
from portbench.metrics import counts


def read(layers):
    trace = layers.get("trace")
    if trace is None or not layers.get("traced_steps"):
        return None
    flops = layers["traced_steps"] * layers["step_flops"]
    return 100.0 * flops / trace.window_s / counts.F32_PEAK
