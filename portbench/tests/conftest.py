"""Shared set-up of the benchmark's tests: a cell at small widths on the
CPU, with its traffic cut to a few images or batches.

Run from the repository's root: ``python -m pytest -q portbench/tests``;
the tests marked ``cuda`` run on a machine with a card and skip here."""
from __future__ import annotations

import json
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

SMALL = dict(vocab_size=60, input_encoding_size=32, rnn_size=48,
             att_hid_size=24, fc_feat_size=64, att_feat_size=64,
             embed_dim=16, gcn_dim=64, gpn_hid_dim=32, num_obj_classes=40,
             num_rel_classes=8)


def load(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def bench():
    return load("BENCHMARK.json")


def cell(name):
    return {w["name"]: w for w in bench()["workloads"]}[name]


def small_config(name):
    cfg = load("portbench", "configs", cell(name)["config"] + ".json")
    cfg.update(SMALL)
    return cfg


def small_traffic(name):
    tr = load("portbench", "traffic", cell(name)["traffic"] + ".json")
    if tr["driver"] == "test_split":
        tr.update(batch_images=2, bucket=64, subgraphs_per_image=40,
                  detections=10, relations=16)
    else:
        tr.update(batch_images=2)
    return tr


@pytest.fixture(autouse=True, scope="session")
def small_drivers():
    """The drivers' split of two dispatches and a short profile."""
    from portbench.drivers import test_split, train_loop
    saved = (test_split.POOL_DISPATCHES, test_split.PROFILE_SECONDS,
             train_loop.PROFILE_SECONDS)
    test_split.POOL_DISPATCHES = 2
    test_split.PROFILE_SECONDS = train_loop.PROFILE_SECONDS = 0.2
    yield
    (test_split.POOL_DISPATCHES, test_split.PROFILE_SECONDS,
     train_loop.PROFILE_SECONDS) = saved


def small_run(name, seed=2 ** 33 + 17, seconds=0.3, trace=False):
    """A run of cell ``name`` at small widths on the CPU, past the
    harness's look for a card."""
    from portbench import harness as H
    return H.Run(bench(), name, seed, seconds, trace, device="cpu",
                 config=small_config(name), traffic=small_traffic(name))


def failing(out):
    """The compared numbers of a result over their limits."""
    return {k for k, c in out["checks"].items() if c["value"] > c["limit"]}


@pytest.fixture
def restore_modules():
    """Undo attribute patches of the program's modules after a test."""
    undo = []

    def patch(module, attr, value):
        undo.append((module, attr, getattr(module, attr)))
        setattr(module, attr, value)

    yield patch
    for module, attr, value in reversed(undo):
        setattr(module, attr, value)
