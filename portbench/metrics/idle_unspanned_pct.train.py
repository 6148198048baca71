"""The share of the traced training window's idle time (no operation on
the card) in which the host ran none of the program's spans: the
benchmark's own glue between steps, in percent."""
from portbench.metrics import program


def read(layers):
    return program.idle_unspanned_pct(layers, "subgc.train.step")
