"""``host_hidden_pct.test`` on a made-up trace and made-up span records:
the busy time under the runner's stacking and caption spans over their
time, with overlapping spans counted once and spans clipped to the window;
nothing to read without a trace, without those spans in the window, or
with a program that records no spans."""
from __future__ import annotations

import types

import pytest
from torch.autograd import DeviceType

from portbench.harness import read_layer_metric
from portbench.metrics.trace import WINDOW, Trace
from subgc_tpu_torch.utils import profiling as PR

NAME = "host_hidden_pct.test"
CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def _event(name, start, end, dev=CPU):
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: start,
        duration_ns=lambda: end - start, device_type=lambda: dev)


def _trace(events, window=(0, 10_000)):
    events = [_event(WINDOW, *window)] + events
    return Trace(types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events))))


@pytest.fixture
def recorded(monkeypatch):
    """Stand the given (name, start, end) spans in for the program's."""
    def use(spans):
        records = [PR.SpanRecord(n, s, e, -1, 1) for n, s, e in spans]
        monkeypatch.setattr(PR, "recorded_spans", lambda: records)
    return use


BUSY = [_event("k", 500, 2_200, CUDA), _event("k", 2_800, 4_000, CUDA),
        _event("k", 6_000, 7_000, CUDA)]


def test_busy_share_of_the_runner_host_spans(recorded):
    recorded([
        ("subgc.test.stack", -500, -100),            # before the window
        ("subgc.test.stack", 0, 1_000),
        ("subgc.test.dispatch", 1_000, 9_000),       # not host work
        ("subgc.decode", 1_000, 2_000),              # not host work
        ("subgc.test.captions", 2_000, 3_000),
        ("subgc.test.stack", 2_500, 3_500),          # overlaps the captions
        ("subgc.test.captions", 9_500, 10_500),      # cut at the window
    ])
    # host: 0-1,000, 2,000-3,500, 9,500-10,000 (3,000); busy within it:
    # 500-1,000, 2,000-2,200, 2,800-3,500 (1,400)
    got = read_layer_metric(NAME, {"trace": _trace(BUSY)})
    assert got == pytest.approx(100 * 1_400 / 3_000)


def test_serial_host_work_reads_zero_and_hidden_reads_100(recorded):
    recorded([("subgc.test.stack", 0, 500),
              ("subgc.test.captions", 2_200, 2_800)])
    assert read_layer_metric(NAME, {"trace": _trace(BUSY)}) == 0.0
    recorded([("subgc.test.stack", 600, 900),
              ("subgc.test.captions", 3_000, 4_000)])
    assert read_layer_metric(NAME, {"trace": _trace(BUSY)}) == 100.0


def test_nothing_to_read(recorded, monkeypatch):
    trace = _trace(BUSY)
    assert read_layer_metric(NAME, {}) is None
    recorded([])
    assert read_layer_metric(NAME, {"trace": trace}) is None
    # spans, but none of the runner's host work in the window
    recorded([("subgc.test.dispatch", 0, 5_000), ("subgc.decode", 0, 4_000),
              ("subgc.test.captions", 10_500, 11_000)])
    assert read_layer_metric(NAME, {"trace": trace}) is None
    # a program with no span recorder
    monkeypatch.delattr(PR, "recorded_spans")
    assert read_layer_metric(NAME, {"trace": trace}) is None
