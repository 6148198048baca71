"""Kernel launches per training step: launch calls that start inside the
program's ``subgc.train.step`` spans, over those spans.  The trace keeps
no thread, so a launch of another thread in the span would count too; the
prefetcher's producer thread only copies, and launches none."""
from portbench.metrics import program


def read(layers):
    return program.calls_per(layers, program.LAUNCHES, "subgc.train.step",
                             "subgc.train.step")
