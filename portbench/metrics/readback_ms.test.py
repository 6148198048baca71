"""Milliseconds a test dispatch spends copying its outputs to the host
(``eval/runner.py``: the program's ``subgc.test.readback`` span): the
host's wait for the card to finish the dispatch, and the copy back."""
from portbench.metrics import program


def read(layers):
    return program.ms_per(layers, ("subgc.test.readback",),
                          "subgc.test.dispatch")
