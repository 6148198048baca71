"""Rounds of the sub-graph NMS fixpoint a test dispatch runs
(``models/gpn.py::subgraph_nms``: the program's ``subgc.gpn.nms_round``
spans); each round tests its stop condition on the host, one sync."""
from portbench.metrics import program


def read(layers):
    return program.count_per(layers, "subgc.gpn.nms_round",
                             "subgc.test.dispatch")
