"""Milliseconds of a dispatch outside the encoder's and the decode's spans:
the runner's stacking, transfers and caption text (``eval/runner.py``)."""


def read(layers):
    n = layers.get("spans_dispatches")
    spans = layers.get("span_s", {})
    if not n or "encode" not in spans or "decode" not in spans:
        return None
    return (layers["spans_wall_s"] - spans["encode"] - spans["decode"]) \
        / n * 1e3
