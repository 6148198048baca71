"""Milliseconds a dispatch spends in the encoder, sGPN and NMS
(``models/subgc.py::encode_images_batched``), from the benchmark's
synchronised span around it."""


def read(layers):
    n = layers.get("spans_dispatches")
    if not n or "encode" not in layers.get("span_s", {}):
        return None
    return layers["span_s"]["encode"] / n * 1e3
