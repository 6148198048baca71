"""Kernel launches of the test decode (``decode/beam.py::beam_search``,
``decode/greedy.py::sample``) per decode step: launch calls that start
inside the program's ``subgc.decode`` spans, over its
``subgc.decode.step`` spans."""
from portbench.metrics import program


def read(layers):
    return program.calls_per(layers, program.LAUNCHES, "subgc.decode",
                             "subgc.decode.step")
