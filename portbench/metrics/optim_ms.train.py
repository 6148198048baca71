"""Milliseconds a training step spends in the optimizer
(``train/step.py``, ``train/optim.py``: the program's
``subgc.train.optim`` span), host time."""
from portbench.metrics import program


def read(layers):
    return program.ms_per(layers, ("subgc.train.optim",),
                          "subgc.train.step")
