"""Milliseconds a test dispatch spends turning tokens into its images'
predictions (``eval/runner.py``: sorting, caption text; the program's
``subgc.test.captions`` span)."""
from portbench.metrics import program


def read(layers):
    return program.ms_per(layers, ("subgc.test.captions",),
                          "subgc.test.dispatch")
