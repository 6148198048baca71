"""Host syncs a test dispatch makes: the runtime's stream, device and
event synchronisations that start inside the program's
``subgc.test.dispatch`` span (``eval/runner.py``), per dispatch."""
from portbench.metrics import program


def read(layers):
    return program.calls_per(layers, program.SYNCS, "subgc.test.dispatch",
                             "subgc.test.dispatch")
