"""Milliseconds a training step spends in its forward and loss
(``train/step.py``: the program's ``subgc.train.forward`` span), host
time: the launches, not waited for."""
from portbench.metrics import program


def read(layers):
    return program.ms_per(layers, ("subgc.train.forward",),
                          "subgc.train.step")
