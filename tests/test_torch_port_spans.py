"""The port's spans (``utils/profiling.py::span``) at its layer boundaries,
on the CPU at tiny Sub-GC widths:

* off path: with no profiler recording, ``span`` is one shared no-op
  context, and a test split and two train steps record nothing, with the
  clock and ``record_function`` patched to raise;
* on path, under ``torch.profiler`` (greedy and beam 2, two dispatches):
  the span names and counts (a dispatch: one ``stack``, ``to_device``,
  ``encode``, ``decode``, ``readback`` and ``captions``, ``seq_length``
  decode steps, at least one NMS round) and their nesting in the runner's
  two stages (dispatch k: its placing, encoding and decoding, dispatch
  k-1's captions, dispatch k+1's stacking, its copy back), and a train
  step's forward, backward and optimizer spans in that order inside it,
  with the prefetcher's spans on the consumer's thread alone;
* clock: a span brackets the profiler's event of an operator run inside it;
* bound: the buffer keeps the newest ``SPAN_CAP`` records.
"""
import collections
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from subgc_tpu_torch.config import EvalConfig, ModelConfig, TrainConfig
from subgc_tpu_torch.data import dataset as DS
from subgc_tpu_torch.data.prefetch import BatchPrefetcher
from subgc_tpu_torch.data.synthetic import synthetic_train_batch
from subgc_tpu_torch.eval import runner
from subgc_tpu_torch.graph import (make_scene_graph, pad_subgraph_set,
                                   subgraphs_from_masks)
from subgc_tpu_torch.models.params import init_params_numpy, params_from_numpy
from subgc_tpu_torch.train import step as step_mod
from subgc_tpu_torch.utils import profiling as PR

CFG = ModelConfig(vocab_size=20, seq_length=14, rnn_size=32,
                  input_encoding_size=24, att_hid_size=16, gcn_dim=20,
                  fc_feat_size=32, att_feat_size=40, embed_dim=10,
                  num_obj_classes=30, num_rel_classes=10, drop_prob_lm=0.0)
IMAGES, BATCH = 4, 2          # two dispatches


@pytest.fixture(autouse=True)
def empty_buffer():
    PR.clear_spans()
    yield
    PR.clear_spans()


class _Split:
    def __init__(self, examples):
        self.examples = examples

    def iter_split(self, split="test", num_images=-1):
        return iter(self.examples)


def _split():
    rng = np.random.RandomState(0)
    out = []
    for i in range(IMAGES):
        g = make_scene_graph(rng.rand(12, CFG.att_feat_size).astype("f"),
                             rng.rand(12, CFG.num_obj_classes).astype("f"),
                             rng.randint(0, 12, (20, 2)),
                             rng.rand(20, CFG.num_rel_classes).astype("f"))
        subs = pad_subgraph_set(subgraphs_from_masks(
            (rng.rand(10, CFG.obj_num) > 0.7).astype("f"),
            (rng.rand(10, CFG.rel_num) > 0.7).astype("f")), 16)
        out.append(DS.TestExample(
            graph=g, subs=subs, n_subgraphs=10,
            info=DS.ImageInfo(ix=i, id=i, file_path=""),
            gts=np.zeros((0, CFG.seq_length), np.int64), sg_raw={}))
    return _Split(out)


def _params(requires_grad=False):
    params, state = init_params_numpy(CFG, seed=0)
    return (params_from_numpy(params, "cpu", requires_grad=requires_grad),
            params_from_numpy(state, "cpu"))


def _test_split(beam):
    params, state = _params()
    ecfg = EvalConfig(beam_size=beam, gpn_max_subg=4,
                      max_subgraph_bucket=16)
    vocab = {str(i): f"w{i}" for i in range(1, CFG.vocab_size + 1)}
    preds = runner.run_test_split(params, state, _split(), CFG, ecfg, vocab,
                                  verbose=False, batch_images=BATCH,
                                  device="cpu")[0]
    assert len(preds) == IMAGES


def _train_steps(n=2):
    """``n`` train steps fed by the prefetcher, as the train CLI runs
    them."""
    params, state = _params(requires_grad=True)
    tcfg = TrainConfig(batch_size=BATCH)
    step = step_mod.make_train_step(CFG, tcfg, ss_active=False)
    ts = step_mod.init_train_state(params, state, tcfg)
    host = synthetic_train_batch(CFG, BATCH, seed=1)
    pf = BatchPrefetcher(lambda: (host,), depth=1, device="cpu",
                         place=lambda b: step_mod.batch_to_device(b, "cpu"))
    try:
        for _ in range(n):
            batch, _ = pf.next()
            ts, metrics = step(ts, batch, None, 0, 0.0)
    finally:
        pf.stop()
    assert not pf.thread.is_alive()
    assert np.isfinite(float(metrics["loss"]))


def _raise(*a, **k):
    raise AssertionError("called with no profiler recording")


def test_no_profiler_records_nothing(monkeypatch):
    assert not torch.autograd._profiler_enabled()
    assert PR.span("subgc.test.dispatch") is PR.span("subgc.decode") \
        is PR._NO_SPAN
    monkeypatch.setattr(PR, "time", types.SimpleNamespace(time_ns=_raise))
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    _test_split(beam=2)
    _train_steps()
    assert PR.recorded_spans() == []


def _by_name(spans):
    out = collections.defaultdict(list)
    for i, r in enumerate(spans):
        out[r.name].append(i)
    return out


def _parents(spans, idx):
    return {spans[spans[i].parent].name if spans[i].parent >= 0 else None
            for i in idx}


@pytest.mark.parametrize("beam", [1, 2], ids=["greedy", "beam2"])
def test_test_split_spans_nest_under_the_profiler(beam):
    with profile(activities=[ProfilerActivity.CPU]):
        _test_split(beam)
    spans = PR.recorded_spans()
    assert all(r.end_ns >= r.start_ns for r in spans)
    by = _by_name(spans)
    n = IMAGES // BATCH
    assert {k: len(v) for k, v in by.items()
            if k != "subgc.gpn.nms_round"} == {
        "subgc.test.split": 1, "subgc.test.dispatch": n,
        "subgc.test.stack": n, "subgc.test.to_device": n,
        "subgc.encode": n, "subgc.decode": n,
        "subgc.decode.step": n * CFG.seq_length,
        "subgc.test.readback": n, "subgc.test.captions": n}
    assert _parents(spans, by["subgc.test.split"]) == {None}
    assert _parents(spans, by["subgc.test.dispatch"]) == {"subgc.test.split"}
    for name in ("subgc.test.to_device", "subgc.encode", "subgc.decode",
                 "subgc.test.readback"):
        assert _parents(spans, by[name]) == {"subgc.test.dispatch"}, name
    assert _parents(spans, by["subgc.gpn.nms_round"]) == {"subgc.encode"}
    assert _parents(spans, by["subgc.decode.step"]) == {"subgc.decode"}

    def start(i):
        return spans[i].start_ns

    # two stages: dispatch k writes dispatch k-1's captions and stacks
    # dispatch k+1's inputs; the split's first stacking and last caption
    # text lie outside every dispatch
    stacks = sorted(by["subgc.test.stack"], key=start)
    texts = sorted(by["subgc.test.captions"], key=start)
    dispatches = sorted(by["subgc.test.dispatch"], key=start)
    split = by["subgc.test.split"][0]
    assert spans[stacks[0]].parent == split
    assert spans[texts[-1]].parent == split
    assert spans[stacks[0]].end_ns <= spans[dispatches[0]].start_ns
    assert spans[dispatches[-1]].end_ns <= spans[texts[-1]].start_ns
    for k, d in enumerate(dispatches):
        kids = sorted((i for i in range(len(spans)) if spans[i].parent == d),
                      key=start)
        # one after another: placing, encoding and decoding this dispatch,
        # the previous one's caption text, the next one's stacking, and
        # this one's copy back
        names = ["subgc.test.to_device", "subgc.encode", "subgc.decode"]
        names += ["subgc.test.captions"] * (k > 0)
        names += ["subgc.test.stack"] * (k < n - 1)
        names += ["subgc.test.readback"]
        assert [spans[i].name for i in kids] == names
        assert all(spans[a].end_ns <= spans[b].start_ns
                   for a, b in zip(kids, kids[1:]))
        if k > 0:
            assert texts[k - 1] in kids
        if k < n - 1:
            assert stacks[k + 1] in kids
        rounds = [i for i in by["subgc.gpn.nms_round"]
                  if spans[i].parent == kids[1]]
        assert len(rounds) >= 1


def test_train_step_spans_nest_under_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]):
        _train_steps()
    spans = PR.recorded_spans()
    by = _by_name(spans)
    assert {k: len(v) for k, v in by.items()} == {
        "subgc.train.next_batch": 2, "subgc.train.step": 2,
        "subgc.train.forward": 2, "subgc.train.backward": 2,
        "subgc.train.optim": 2}
    # the consumer's thread alone: the producer records no span
    assert {r.thread for r in spans} == {threading.get_ident()}
    for s in by["subgc.train.step"]:
        kids = [i for i in range(len(spans)) if spans[i].parent == s]
        assert [spans[i].name for i in kids] == [
            "subgc.train.forward", "subgc.train.backward",
            "subgc.train.optim"]
        assert all(spans[a].end_ns <= spans[b].start_ns
                   for a, b in zip(kids, kids[1:]))
        assert spans[kids[-1]].end_ns <= spans[s].end_ns
    assert _parents(spans, by["subgc.train.next_batch"]) == {None}


def test_a_span_brackets_the_profilers_event_inside_it():
    x = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with PR.span("outer"):
                x = torch.mul(x, 2.0)
    spans = PR.recorded_spans()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::mul"]
    assert len(spans) == len(events) == 3
    for r, e in zip(spans, events):
        assert r.start_ns <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= r.end_ns


def test_the_buffer_keeps_the_newest_records():
    with profile(activities=[ProfilerActivity.CPU]):
        with PR.span("p"):
            for i in range(PR.SPAN_CAP + 1):
                with PR.span("c"):
                    pass
    spans = PR.recorded_spans()
    # appended as they close: the first two children are dropped, and the
    # parent, closed last, opened first
    assert len(spans) == PR.SPAN_CAP
    assert spans[0].name == "p" and spans[0].parent == -1
    assert all(r.name == "c" and r.parent == 0 for r in spans[1:])
    assert spans[1].start_ns >= spans[0].start_ns
