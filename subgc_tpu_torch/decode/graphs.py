"""Beam searches replayed from captured CUDA graphs.

A beam search on the card launches ~86 kernels a step from Python, and at
the Kar shape (160 rows, 2 beams) the card finishes each long before the
host has launched the next: the search is bound by its launches.  Its step
loop makes no host sync and, for one key (below), the same launches with
the same shapes in every call.  So :class:`SearchGraphs` captures the
search once and replays it:

* the search is a generator (``beam._search``) that yields after each
  outer step; each stretch between two yields, and the final pick after the
  last, is captured as one CUDA graph, in order, into one memory pool, so
  that a graph reads its predecessor's outputs where they lie;
* the call's ``PreparedFeatures`` are copied into the chain's own input
  buffers before the replays; the weights are read where they live, so a
  replay sees an update in place, and a tensor replaced in the dict changes
  the key.  What a call derives from the weights (the bf16 casts, the
  split route's prepared weights) is recomputed inside the first graph in
  every replay, never carried over from an earlier call;
* the outputs are cloned out of the pool, so a result held across calls
  does not change when the next replay runs;
* the launch counters of every ops module (``ops/_counts.py::SETS``)
  advance at each replay by what the capture counted on the capturing
  thread, so they count kernel runs whichever way the search ran; a
  capture that fails leaves them as it found them.

The policy, per key: a key's first call decodes eagerly; its second
captures (then replays); later calls replay.  A shape seen once (a short
last dispatch, a serving batch of odd size) never pays for a capture.  At
most :data:`CAPACITY` chains are kept, the least recently used evicted.
An evicted chain is freed only when the card is done with its replays,
also with a replay that another thread is still enqueuing.  CPU tensors,
and a call made while the stream is already capturing, always decode
eagerly.  A key repeats where the row count does: the runner rounds a beam
decode's kept rows up to a bucket (``eval/runner.py::BEAM_ROW_BUCKET``).

The key is everything that changes the captured work: the device, the
``PreparedFeatures`` layout (which fields are None, each field's shape and
dtype: ``S``, the node counts, the image count), the ``ModelConfig`` (``T``,
the vocabulary, the compute dtype and bf16 flags), the ``EvalConfig``
fields the search reads (``beam_size``, ``group_size``,
``diversity_lambda``, ``decoding_constraint``, ``length_penalty``), each
decoder weight's address, shape, strides and dtype, the split route's row
threshold, and torch's matmul numerics flags.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import NamedTuple, Optional

import torch

from ..models import decoder as D
from ..ops import _counts
from ..utils.profiling import span

CAPACITY = 8           # chains kept (a Kar dispatch's holds ~41 MB)
SEEN_CAPACITY = 64     # keys remembered as called once
CAPTURE = object()     # SearchGraphs.admit: the key's second call
_CAPTURE_LOCK = threading.Lock()    # one capture at a time in the process


def drive(steps):
    """Run a search generator to its end, eagerly; returns its result."""
    while True:
        try:
            next(steps)
        except StopIteration as end:
            return end.value


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def search_key(params, feats: D.PreparedFeatures, cfg, ecfg):
    """The key of a search's captured work (module docstring), on any
    device."""
    fields = tuple(None if x is None else (tuple(x.shape), x.dtype)
                   for x in feats)
    weights = tuple((name, w.data_ptr(), tuple(w.shape), w.stride(),
                     w.dtype, w.device)
                    for name, w in _named_leaves(params["decoder"]))
    mm = torch.backends.cuda.matmul
    numerics = (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction,
                mm.allow_fp16_reduced_precision_reduction,
                torch.are_deterministic_algorithms_enabled())
    return (feats.fc.device, fields, cfg, ecfg.beam_size, ecfg.group_size,
            ecfg.diversity_lambda, ecfg.decoding_constraint,
            ecfg.length_penalty, weights, D.SPLIT_GEMM_MIN_ROWS, numerics)


def _thread_counts():
    return [(c, c.thread_counts()) for c in _counts.SETS]


def _advance(before):
    """What the calling thread launched since ``before`` (of
    :func:`_thread_counts`): (counter set, counter name -> launches)
    pairs."""
    out = []
    for c, was in before:
        now = c.thread_counts()
        moved = {k: now[k] - was[k] for k in now if now[k] != was[k]}
        if moved:
            out.append((c, moved))
    return out


def _count(advance, sign=1):
    """Add ``advance`` (of :func:`_advance`), times ``sign``, to the
    counters."""
    for c, moved in advance:
        c.add({k: sign * n for k, n in moved.items()})


class _Step(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    counts: list        # the capture's launches (of _advance)


class Chain:
    """One key's captured search: its input buffers, its graphs in order
    (one an outer step, then the final pick) and the outputs they leave in
    the pool."""

    def __init__(self, device, inputs, steps, out):
        self.device = device
        self.inputs = inputs
        self.steps = steps
        self.out = out
        self.lock = threading.Lock()    # one replay of the chain at a time
        self.free = torch.cuda.Event()  # its last replay's end, on the card
        self.retired = False            # evicted: a replay waits for its end

    def replay(self, feats: D.PreparedFeatures):
        """The search on ``feats`` from the graphs, on the current stream;
        returns the caller's own copy of the outputs."""
        with self.lock, torch.cuda.device(self.device):
            stream = torch.cuda.current_stream()
            stream.wait_event(self.free)     # a replay on another stream
            for buf, x in zip(self.inputs, feats):
                if buf is not None:
                    buf.copy_(x)
            *outer, final = self.steps
            for step in outer:
                with span("subgc.decode.step"):
                    step.graph.replay()
                _count(step.counts)
            final.graph.replay()                    # the final pick
            _count(final.counts)
            out = type(self.out)(*(x.clone() for x in self.out))
            self.free.record(stream)
            if self.retired:
                # evicted while this thread held it: the last reference may
                # go when this call returns, and the pool with it
                self.free.synchronize()
        return out

    def retire(self):
        """Wait until the card is done with the chain's replays: the one
        another thread may be enqueuing, and any that a thread holding the
        chain starts later."""
        with self.lock:
            self.retired = True
            self.free.synchronize()


def capture(search, params, feats: D.PreparedFeatures, cfg, ecfg) -> Chain:
    """Capture ``search(params, inputs, cfg, ecfg)`` (a generator that
    yields after each outer step) as a :class:`Chain` of graphs over input
    buffers holding ``feats``; nothing runs until a replay."""
    dev = feats.fc.device
    with torch.cuda.device(dev):
        inputs = D.PreparedFeatures(*(
            None if x is None
            else x.clone(memory_format=torch.contiguous_format)
            for x in feats))
        side = torch.cuda.Stream()       # a capture needs its own stream
        pool = torch.cuda.graph_pool_handle()
        steps, counted, out = [], [], None
        run = search(params, inputs, cfg, ecfg)
        try:
            with _CAPTURE_LOCK, torch.cuda.stream(side):
                while out is None:
                    graph = torch.cuda.CUDAGraph()
                    before = _thread_counts()
                    graph.capture_begin(pool=pool,
                                        capture_error_mode="thread_local")
                    try:
                        next(run)
                    except StopIteration as end:
                        out = end.value
                    finally:
                        counted.append(_advance(before))
                        graph.capture_end()
                    steps.append(_Step(graph, counted[-1]))
        finally:
            # the launches counted while capturing ran nothing: take them
            # back, also when the capture failed; the replays count them
            for advance in counted:
                _count(advance, sign=-1)
    return Chain(dev, inputs, steps, out)


class SearchGraphs:
    """The captured searches of a process, by key (module docstring)."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._seen = OrderedDict()      # keys called once
        self._chains = OrderedDict()    # key -> Chain, least recent first

    def __len__(self):
        return len(self._chains)

    def clear(self):
        """Forget every key: each one's next call decodes eagerly."""
        with self._lock:
            chains = list(self._chains.values())
            self._chains.clear()
            self._seen.clear()
        for chain in chains:
            chain.retire()

    def admit(self, key) -> Optional[object]:
        """A call's way for ``key``: its :class:`Chain` (replay),
        :data:`CAPTURE` (its second call), or None (its first: eager)."""
        with self._lock:
            chain = self._chains.get(key)
            if chain is not None:
                self._chains.move_to_end(key)
                return chain
            if self._seen.pop(key, False):
                return CAPTURE
            self._seen[key] = True
            while len(self._seen) > SEEN_CAPACITY:
                self._seen.popitem(last=False)
            return None

    def keep(self, key, chain):
        """Keep ``chain`` for ``key``, evicting the least recently used
        beyond :attr:`capacity`."""
        with self._lock:
            self._chains[key] = chain
            evicted = []
            while len(self._chains) > self.capacity:
                evicted.append(self._chains.popitem(last=False)[1])
        for old in evicted:
            old.retire()

    def run(self, search, params, feats: D.PreparedFeatures, cfg, ecfg):
        """``search(params, feats, cfg, ecfg)``'s result: eagerly, or from
        the graphs (module docstring)."""
        if (feats.fc.device.type != "cuda"
                or torch.cuda.is_current_stream_capturing()):
            return drive(search(params, feats, cfg, ecfg))
        key = search_key(params, feats, cfg, ecfg)
        way = self.admit(key)
        if way is None:
            return drive(search(params, feats, cfg, ecfg))
        if way is CAPTURE:
            way = capture(search, params, feats, cfg, ecfg)
            self.keep(key, way)
        return way.replay(feats)


SEARCHES = SearchGraphs()       # beam.beam_search's
