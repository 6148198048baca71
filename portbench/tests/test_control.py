"""The control and the planted faults fail the output check: on the card,
at the published widths with a few images or a smaller batch, the
reference computed with TF32 in the program's place, and for training the
reference with half of the batch or a caption token altered, each read
above a limit of the cell.  The benchmark's runs do not run this; the
readings at each cell's own size come from ``portbench/control.py``."""
from __future__ import annotations

import pytest
import torch

from conftest import bench, failing
from portbench import control
from portbench import harness as H

CELLS = [w["name"] for w in bench()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 is a mode of the card")
    yield
    control.tf32(False)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail_the_check(card, name):
    run = H.Run(bench(), name, 2 ** 31 + 77, 0, False)
    if run.traffic["driver"] == "test_split":
        run.traffic.update(batch_images=2)
    else:
        run.traffic.update(batch_images=8)
    numbers = control.numbers(run)
    assert numbers
    for kind, values in numbers.items():
        out = {"checks": {k: {"value": v, "limit": run.limits[k]}
                          for k, v in values.items()}}
        assert failing(out), (kind, values)
