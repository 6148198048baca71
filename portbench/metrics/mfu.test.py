"""The test path's share of the card's float32 peak over the traced
window: the operations the window's dispatches need (``counts.test_image``
from the reference's keep sets) over the window, over 67 TFLOP/s, in
percent."""
from portbench.metrics import counts


def read(layers):
    trace, work = layers.get("trace"), layers.get("work")
    if trace is None or not work:
        return None
    flops = layers["traced_calls"] * sum(f for f, _, _ in work)
    return 100.0 * flops / trace.window_s / counts.F32_PEAK
