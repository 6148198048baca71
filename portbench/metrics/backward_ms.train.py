"""Milliseconds a training step spends in autograd
(``train/step.py``: the program's ``subgc.train.backward`` span around
``torch.autograd.grad``), host time."""
from portbench.metrics import program


def read(layers):
    return program.ms_per(layers, ("subgc.train.backward",),
                          "subgc.train.step")
