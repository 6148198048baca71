"""Per-layer readers, one file a metric (``<metric>.py``, ``read(layers)``
returns the value or None where the run gave nothing to read), and what
they share: the work counts (``counts.py``) and the trace reader
(``trace.py``)."""
