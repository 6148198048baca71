"""Milliseconds a test dispatch spends stacking its images' arrays and
placing them on the card (``eval/runner.py``: the program's
``subgc.test.stack`` and ``subgc.test.to_device`` spans), host time."""
from portbench.metrics import program


def read(layers):
    return program.ms_per(layers, ("subgc.test.stack", "subgc.test.to_device"),
                          "subgc.test.dispatch")
