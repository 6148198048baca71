"""The readers of the program's own spans (``metrics/program.py`` and the
metrics that use it) on a made-up trace and made-up span records: the
division by dispatches and steps, clipping to the window, the idle
arithmetic over overlapping spans, launches and syncs counted by the span
they start in, and nothing to read where the window holds no span or the
program records none."""
from __future__ import annotations

import types

import pytest
from torch.autograd import DeviceType

from portbench.harness import read_layer_metric
from portbench.metrics.trace import WINDOW, Trace
from subgc_tpu_torch.utils import profiling as PR

TEST = ("inputs_ms.test", "readback_ms.test", "captions_ms.test",
        "nms_rounds.test", "syncs.test", "launches_per_step.test",
        "idle_unspanned_pct.test")
TRAIN = ("forward_ms.train", "backward_ms.train", "optim_ms.train",
         "launches_per_step.train", "idle_unspanned_pct.train")
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


def _read(names, trace):
    return {n: read_layer_metric(n, {"trace": trace}) for n in names}


TEST_SPANS = [
    # dispatch 1, partly before the window: its stacking is cut off
    ("subgc.test.dispatch", -500, 2_100), ("subgc.test.stack", -500, -100),
    ("subgc.test.to_device", 300, 500),
    ("subgc.encode", 500, 900),
    ("subgc.gpn.nms_round", 600, 700), ("subgc.gpn.nms_round", 700, 800),
    ("subgc.gpn.nms_round", 800, 850),
    ("subgc.decode", 900, 1_400),
    *[("subgc.decode.step", 900 + 100 * i, 1_000 + 100 * i)
      for i in range(4)],
    ("subgc.test.readback", 1_500, 1_900),
    ("subgc.test.captions", 1_900, 2_100),
    # dispatch 2
    ("subgc.test.dispatch", 3_000, 5_000), ("subgc.test.stack", 3_000, 3_400),
    ("subgc.test.to_device", 3_400, 3_500),
    ("subgc.encode", 3_500, 3_600), ("subgc.gpn.nms_round", 3_500, 3_550),
    ("subgc.decode", 3_600, 4_400),
    *[("subgc.decode.step", 3_600 + 200 * i, 3_800 + 200 * i)
      for i in range(4)],
    ("subgc.test.readback", 4_500, 4_800),
    ("subgc.test.captions", 4_800, 5_000),
    # after the window: not read
    ("subgc.test.dispatch", 10_500, 11_000),
    ("subgc.test.readback", 10_600, 10_700),
]
TEST_EVENTS = [
    _event("cudaStreamSynchronize", 700, 710),       # dispatch 1
    _event("cudaStreamSynchronize", 1_600, 1_890),   # dispatch 1, readback
    _event("cudaEventSynchronize", 3_550, 3_560),    # dispatch 2
    _event("cudaStreamSynchronize", 6_000, 6_010),   # between dispatches
    _event("cudaLaunchKernel", 950, 955),            # decode 1
    _event("cudaLaunchKernelExC", 1_399, 1_402),     # decode 1, at its end
    _event("cudaLaunchKernel", 1_400, 1_405),        # just after decode 1
    _event("cuLaunchKernel", 3_700, 3_705),          # decode 2
    _event("cudaLaunchKernel", 3_800, 3_805),        # decode 2
    _event("cudaLaunchKernel", 890, 899),            # encoder: not decode
    _event("cudaMemcpyAsync", 1_000, 1_010),         # a copy: neither
    _event("k", 600, 1_000, CUDA), _event("k", 1_300, 1_700, CUDA),
    _event("k", 3_500, 4_000, CUDA),
]


def test_test_readers_divide_by_dispatches_and_clip(recorded):
    recorded(TEST_SPANS)
    got = _read(TEST, _trace(TEST_EVENTS))
    assert got["inputs_ms.test"] == pytest.approx((200 + 400 + 100) / 2e6)
    assert got["readback_ms.test"] == pytest.approx((400 + 300) / 2e6)
    assert got["captions_ms.test"] == pytest.approx((200 + 200) / 2e6)
    assert got["nms_rounds.test"] == pytest.approx(4 / 2)
    assert got["syncs.test"] == pytest.approx(3 / 2)
    assert got["launches_per_step.test"] == pytest.approx(4 / 8)
    # idle: window 10,000 less busy 400 + 400 + 500; covered by spans:
    # 0-600, 1,000-1,300, 1,700-2,100, 3,000-3,500 and 4,000-5,000
    idle = 10_000 - 1_300
    covered = 600 + 300 + 400 + 500 + 1_000
    assert got["idle_unspanned_pct.test"] == pytest.approx(
        100 * (idle - covered) / idle)


def test_idle_counts_overlapping_spans_once(recorded):
    recorded([("subgc.train.step", 50, 400), ("subgc.train.forward", 50, 200),
              ("subgc.train.backward", 200, 500),
              ("subgc.train.next_batch", 650, 800),
              ("subgc.train.next_batch", 700, 750),
              ("other", 850, 950)])                   # not the program's
    trace = _trace([_event("k", 100, 300, CUDA), _event("k", 600, 700, CUDA)],
                   window=(0, 1_000))
    # idle 0-100, 300-600, 700-1,000 (700); covered 50-100, 300-500,
    # 700-800 (350)
    assert read_layer_metric("idle_unspanned_pct.train",
                             {"trace": trace}) == pytest.approx(50.0)


def test_train_readers_divide_by_steps(recorded):
    recorded([("subgc.train.next_batch", 0, 100),
              ("subgc.train.step", 100, 1_000),
              ("subgc.train.forward", 100, 400),
              ("subgc.train.backward", 400, 800),
              ("subgc.train.optim", 800, 1_000),
              ("subgc.train.next_batch", 1_000, 1_050),
              ("subgc.train.step", 1_050, 2_050),
              ("subgc.train.forward", 1_050, 1_250),
              ("subgc.train.backward", 1_250, 1_950),
              ("subgc.train.optim", 1_950, 2_050)])
    trace = _trace([_event("cudaLaunchKernel", t, t + 5)
                    for t in (150, 500, 900, 1_100, 1_960)]
                   + [_event("cudaLaunchKernel", 50, 55),   # next_batch
                      _event("k", 200, 2_000, CUDA)], window=(0, 2_100))
    got = _read(TRAIN, trace)
    assert got["forward_ms.train"] == pytest.approx((300 + 200) / 2e6)
    assert got["backward_ms.train"] == pytest.approx((400 + 700) / 2e6)
    assert got["optim_ms.train"] == pytest.approx((200 + 100) / 2e6)
    assert got["launches_per_step.train"] == pytest.approx(5 / 2)
    # idle 0-200 (covered) and 2,000-2,100 (covered to 2,050)
    assert got["idle_unspanned_pct.train"] == pytest.approx(100 * 50 / 300)


def test_nothing_to_read_without_spans_in_the_window(recorded, monkeypatch):
    trace = _trace([_event("k", 100, 200, CUDA),
                    _event("cudaLaunchKernel", 50, 55)], window=(0, 1_000))
    recorded([("subgc.test.dispatch", 2_000, 3_000),
              ("subgc.train.step", -300, -100)])
    assert set(_read(TEST + TRAIN, trace).values()) == {None}
    assert read_layer_metric("inputs_ms.test", {}) is None
    # a program with no span recorder
    monkeypatch.delattr(PR, "recorded_spans")
    assert set(_read(TEST + TRAIN, trace).values()) == {None}
