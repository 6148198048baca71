"""The share of the traced test window's idle time (no operation on the
card) in which the host ran none of the program's spans: the benchmark's
own glue between calls, in percent."""
from portbench.metrics import program


def read(layers):
    return program.idle_unspanned_pct(layers, "subgc.test.dispatch")
