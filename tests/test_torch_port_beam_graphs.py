"""Beam searches replayed from captured CUDA graphs (``decode/graphs.py``).

On the CPU: the cache key changes with every input that changes the
captured work, and with a replaced weight, and not with new values of the
same layout or a weight updated in place; the policy (eager on a key's
first call, capture on its second, replay after, the least recently used
chain evicted); an evicted chain waits for a replay another thread is
enqueuing; a capture that fails leaves the launch counters as it found
them (both with the CUDA calls faked); CPU tensors never capture; each
thread's launch counts; the runner's row buckets.

On a card (``cuda``): graph against eager, bit for bit (``seq``,
``logprobs``, ``all_seqs``, ``all_ps``) and with equal launch-counter
advances, over seven searches at published widths; a weight updated in
place shows in the next replay; a result held from one call is unchanged
after the next; a second shape captures beside the first; dispatches with
different kept counts share one bucketed key.

This file imports neither jax nor the JAX package, so its ``cuda`` tests
run on a GPU machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_port_beam_graphs.py
"""
import contextlib
import threading
import types

import numpy as np
import pytest
import torch

from subgc_tpu_torch.config import EvalConfig, ModelConfig, build_configs
from subgc_tpu_torch.decode import beam as B
from subgc_tpu_torch.decode import graphs as GR
from subgc_tpu_torch.eval import runner as R
from subgc_tpu_torch.models import decoder as D
from subgc_tpu_torch.models.params import init_params_numpy, params_from_numpy
from subgc_tpu_torch.ops import attention as A
from subgc_tpu_torch.ops import gemm as GM

TINY = dict(vocab_size=20, rnn_size=64, input_encoding_size=48,
            att_hid_size=32, gcn_dim=40, fc_feat_size=64, att_feat_size=80,
            embed_dim=20, num_obj_classes=30, num_rel_classes=10,
            obj_num=12, seq_length=5)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread at the tiny widths: the test workers share the
    cores.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_cache():
    """Every test starts and ends with no key seen and no chain kept."""
    GR.SEARCHES.clear()
    yield
    GR.SEARCHES.clear()


def _feats(cfg, params, image_shared, images=4, slots=5, n=12, N=4, seed=0,
           device="cpu"):
    """Rows of ``images`` x ``slots`` sub-graphs over ``n`` nodes an image
    (``N`` a sub-graph), prepared as the runner prepares them."""
    rng = np.random.RandomState(seed)

    def t(x):
        return torch.from_numpy(x).to(device)

    x_obj = t(np.maximum(rng.randn(images, n, cfg.gcn_dim), 0).astype("f")
              * 0.3)
    fc = t(rng.randn(images, slots, 2 * cfg.gcn_dim).astype("f") * 0.3)
    oi = t(rng.randint(0, n, (images, slots, N)))
    am = t((rng.rand(images, slots, N) < 0.7).astype("f"))
    am[..., 0] = 1.0
    with torch.no_grad():
        f = D.prepare_features_nodes(params, fc, x_obj, oi, am, cfg,
                                     image_shared=image_shared)
    S = images * slots

    def flat(x):
        return None if x is None else x.reshape((S,) + x.shape[2:])

    return D.PreparedFeatures(
        fc=flat(f.fc), att=flat(f.att), p_att=flat(f.p_att),
        mask=flat(f.mask), fc_ih=flat(f.fc_ih), att_img=f.att_img,
        p_att_img=f.p_att_img,
        img_ix=(torch.arange(images, device=device).repeat_interleave(slots)
                if image_shared else None))


def _tiny(seed=0, **kw):
    cfg = ModelConfig(**{**TINY, **kw})
    p, _ = init_params_numpy(cfg, seed=seed)
    return cfg, params_from_numpy(p, "cpu")


def _key(params, feats, cfg, ecfg):
    return GR.search_key(params, feats, cfg, ecfg)


# ---- the key

ECFG = EvalConfig(beam_size=2)


def _changed(case, monkeypatch, params, feats, cfg):
    """(params, feats, cfg, ecfg) with one input changed by ``case``."""
    ecfg = ECFG
    if case == "rows":
        feats = _feats(cfg, params, image_shared=True, slots=3)
    elif case == "images":
        feats = _feats(cfg, params, image_shared=True, images=2, slots=10)
    elif case == "nodes":
        feats = _feats(cfg, params, image_shared=True, n=9)
    elif case == "layout":
        feats = _feats(cfg, params, image_shared=False)
    elif case == "no_img_ix":
        feats = feats._replace(img_ix=None)
    elif case == "field_dtype":
        feats = feats._replace(mask=feats.mask.double())
    elif case == "seq_length":
        cfg = cfg.replace(seq_length=6)
    elif case == "vocab":
        cfg, params = _tiny(vocab_size=21)
        feats = _feats(cfg, params, image_shared=True)
    elif case == "compute_dtype":
        cfg = cfg.replace(compute_dtype="bfloat16")
    elif case == "bf16_lstm_gates":
        cfg = cfg.replace(bf16_lstm_gates=True)
    elif case == "beam_size":
        ecfg = ecfg.replace(beam_size=3)
    elif case == "group_size":
        ecfg = ecfg.replace(beam_size=4, group_size=2)
    elif case == "diversity_lambda":
        ecfg = ecfg.replace(diversity_lambda=0.25)
    elif case == "decoding_constraint":
        ecfg = ecfg.replace(decoding_constraint=1)
    elif case == "length_penalty":
        ecfg = ecfg.replace(length_penalty="wu_0.9")
    elif case == "replaced_weight":
        dec = dict(params["decoder"])
        dec["logit"] = {**dec["logit"], "w": dec["logit"]["w"].clone()}
        params = {**params, "decoder": dec}
    elif case == "split_rows":
        monkeypatch.setattr(D, "SPLIT_GEMM_MIN_ROWS", 7)
    elif case == "tf32":
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                            not torch.backends.cuda.matmul.allow_tf32)
    elif case == "bf16_reduction":
        flags = torch.backends.cuda.matmul
        monkeypatch.setattr(flags, "allow_bf16_reduced_precision_reduction",
                            not flags.allow_bf16_reduced_precision_reduction)
    else:
        raise AssertionError(case)
    return params, feats, cfg, ecfg


KEY_CASES = ["rows", "images", "nodes", "layout", "no_img_ix", "field_dtype",
             "seq_length", "vocab", "compute_dtype", "bf16_lstm_gates",
             "beam_size", "group_size", "diversity_lambda",
             "decoding_constraint", "length_penalty", "replaced_weight",
             "split_rows", "tf32", "bf16_reduction"]


@pytest.mark.parametrize("case", KEY_CASES)
def test_key_changes_with_what_changes_the_captured_work(case, monkeypatch):
    cfg, params = _tiny()
    feats = _feats(cfg, params, image_shared=True)
    base = _key(params, feats, cfg, ECFG)
    assert _key(params, _feats(cfg, params, image_shared=True, seed=1), cfg,
                ECFG) == base
    assert _key(*_changed(case, monkeypatch, params, feats, cfg)) != base


def test_key_holds_for_new_values_and_weights_updated_in_place():
    """New feature values of the same layout, and a weight updated in
    place, replay the same graphs: the key is unchanged."""
    cfg, params = _tiny()
    key = _key(params, _feats(cfg, params, image_shared=True), cfg, ECFG)
    other = _feats(cfg, params, image_shared=True, seed=5)
    with torch.no_grad():
        params["decoder"]["logit"]["w"].mul_(1.5)
    assert _key(params, other, cfg, ECFG) == key
    # an equal configuration object of its own: the same key
    assert _key(params, other, ModelConfig(**TINY),
                EvalConfig(beam_size=2)) == key


# ---- the policy

class _FakeChain:
    def __init__(self):
        self.retired = 0

    def retire(self):
        self.retired += 1


def test_policy_eager_then_capture_then_replay():
    cache = GR.SearchGraphs(capacity=2)
    assert cache.admit("a") is None            # first call: eager
    assert cache.admit("a") is GR.CAPTURE      # second: capture
    chain = _FakeChain()
    cache.keep("a", chain)
    assert cache.admit("a") is chain           # later: replay
    assert cache.admit("a") is chain
    assert len(cache) == 1


def test_a_shape_seen_once_never_captures():
    cache = GR.SearchGraphs(capacity=2)
    for key in range(5):
        assert cache.admit(key) is None
    assert len(cache) == 0
    # the memory of keys seen once is bounded; the oldest is forgotten
    for key in range(GR.SEEN_CAPACITY + 1):
        cache.admit(("x", key))
    assert cache.admit(("x", 0)) is None
    assert cache.admit(("x", GR.SEEN_CAPACITY)) is GR.CAPTURE


def test_least_recently_used_chain_is_evicted():
    cache = GR.SearchGraphs(capacity=2)
    chains = {k: _FakeChain() for k in "abc"}
    for k in "ab":
        cache.admit(k)
        cache.admit(k)
        cache.keep(k, chains[k])
    assert cache.admit("a") is chains["a"]     # b is now the oldest
    cache.admit("c")
    cache.admit("c")
    cache.keep("c", chains["c"])
    assert len(cache) == 2
    assert chains["b"].retired == 1 and not chains["a"].retired
    assert cache.admit("a") is chains["a"]
    assert cache.admit("c") is chains["c"]
    assert cache.admit("b") is None            # seen again from the start
    cache.clear()
    assert len(cache) == 0 and chains["a"].retired == 1


@pytest.mark.parametrize("image_shared", [True, False])
def test_cpu_searches_never_capture(image_shared):
    """On CPU tensors every call decodes eagerly: no key is seen, no chain
    kept, and each call gives the eager search's result."""
    cfg, params = _tiny(seed=2)
    feats = _feats(cfg, params, image_shared=image_shared, seed=2)
    with torch.no_grad():
        want = GR.drive(B._search(params, feats, cfg, ECFG))
    for _ in range(3):
        got = B.beam_search(params, feats, cfg, ECFG)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert len(GR.SEARCHES) == 0 and not GR.SEARCHES._seen


@pytest.mark.parametrize("ops", [A, GM], ids=["attention", "gemm"])
def test_thread_counts_are_the_calling_threads(ops):
    """A thread's own counts move with its own launches alone; the
    counters with every thread's, and with a replay's added counts."""
    counts = ops.COUNTS
    assert counts in GR._counts.SETS
    name = counts.names[0]
    mine = counts.thread_counts()
    total = getattr(ops, name)

    def other(n):
        t = threading.Thread(target=counts.add, args=({name: n},))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()

    other(3)
    assert counts.thread_counts() == mine
    assert getattr(ops, name) == total + 3
    counts.add({name: 2})
    assert counts.thread_counts()[name] == mine[name] + 2
    assert getattr(ops, name) == total + 5
    counts.add({name: -2})
    other(-3)
    assert getattr(ops, name) == total
    assert counts.thread_counts() == mine


# ---- replays, eviction and capture with the CUDA calls faked

class _Log:
    """The order of the fake card's events."""

    def __init__(self):
        self.items = []
        self.lock = threading.Lock()

    def add(self, item):
        with self.lock:
            self.items.append(item)


class _FakeEvent:
    def __init__(self, log):
        self.log = log

    def record(self, stream=None):
        self.log.add("record")

    def synchronize(self):
        self.log.add("synchronize")


class _FakeStream:
    def wait_event(self, event):
        pass


class _BlockingGraph:
    """A graph whose replay waits until the test releases it."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()

    def replay(self):
        self.entered.set()
        assert self.release.wait(timeout=60)


def _nothing(*a, **k):
    return contextlib.nullcontext()


@pytest.fixture
def fake_card(monkeypatch):
    """``torch.cuda``'s device, stream, event and graph calls, faked on
    the CPU; yields the log of the fake events."""
    log = _Log()
    monkeypatch.setattr(torch.cuda, "device", _nothing)
    monkeypatch.setattr(torch.cuda, "stream", _nothing)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "Event", lambda: _FakeEvent(log))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    yield log


def _fake_chain(graph):
    out = B.BeamOut(*(torch.zeros(2) for _ in B.BeamOut._fields))
    return GR.Chain(torch.device("cpu"), (None,), [GR._Step(graph, [])], out)


def _thread(fn):
    t = threading.Thread(target=fn, daemon=True)
    t.start()
    return t


@pytest.mark.parametrize("order", ["retire_while_replaying",
                                   "replay_after_retire"])
def test_evicted_chain_outlives_its_last_replay(fake_card, order):
    """A chain evicted while a thread replays it, or replayed by a thread
    that took it before its eviction, is waited for on the card after
    that replay was recorded: its pool is never freed under a replay."""
    graph = _BlockingGraph()
    chain = _fake_chain(graph)
    cache = GR.SearchGraphs(capacity=1)
    cache.keep("a", chain)
    if order == "retire_while_replaying":
        replay = _thread(lambda: chain.replay((None,)))
        assert graph.entered.wait(timeout=60)
        evict = _thread(lambda: cache.keep("b", _fake_chain(graph)))
        evict.join(timeout=0.5)
        assert evict.is_alive(), "eviction did not wait for the replay"
        graph.release.set()
        for t in (replay, evict):
            t.join(timeout=60)
            assert not t.is_alive()
        assert fake_card.items == ["record", "synchronize"]
    else:
        got = cache.admit("a")              # taken before its eviction
        cache.keep("b", _fake_chain(graph))
        assert fake_card.items == ["synchronize"] and chain.retired
        graph.release.set()
        got.replay((None,))
        assert fake_card.items == ["synchronize", "record", "synchronize"]
    assert cache.admit("a") is None and len(cache) == 1


class _FakeGraph:
    def capture_begin(self, pool=None, capture_error_mode=None):
        assert capture_error_mode == "thread_local"

    def capture_end(self):
        pass


@pytest.mark.parametrize("fails", [False, True], ids=["captured", "failed"])
def test_capture_leaves_the_counters_as_it_found_them(fake_card,
                                                      monkeypatch, fails):
    """What a capture launches is counted by its replays, not by the
    capture: a capture, whole or failed part way, leaves every counter and
    the thread's own counts as they were."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)

    def search(params, feats, cfg, ecfg):
        A.count_launch("LAUNCHES")
        GM.count_launch()
        yield
        A.count_launch("LAUNCHES")
        if fails:
            raise RuntimeError("an operation that cannot be captured")
        return "out"

    before = ({n: getattr(A, n) for n in A.COUNTS.names},
              {n: getattr(GM, n) for n in GM.COUNTS.names},
              A.COUNTS.thread_counts(), GM.COUNTS.thread_counts())
    feats = D.PreparedFeatures(*([torch.zeros(2)] + [None] * 7))
    if fails:
        with pytest.raises(RuntimeError, match="cannot be captured"):
            GR.capture(search, None, feats, None, None)
    else:
        chain = GR.capture(search, None, feats, None, None)
        assert chain.out == "out"
        assert [{k: n for _, moved in step.counts for k, n in moved.items()}
                for step in chain.steps] == [
            {"LAUNCHES": 1, "PROJECT_LAUNCHES": 1, "GEMM_LAUNCHES": 1},
            {"LAUNCHES": 1, "PROJECT_LAUNCHES": 1}]
    assert before == ({n: getattr(A, n) for n in A.COUNTS.names},
                      {n: getattr(GM, n) for n in GM.COUNTS.names},
                      A.COUNTS.thread_counts(), GM.COUNTS.thread_counts())


# ---- the runner's row buckets

@pytest.mark.parametrize("n,S,bucket,want", [
    (10, 20, 4, 12), (12, 20, 4, 12), (10, 20, 32, 20), (1, 512, 32, 32),
    (49, 512, 32, 64), (64, 512, 32, 64), (150, 160, 32, 160),
    (7, 20, 1, 7)])
def test_kept_rows_round_up_to_their_bucket(n, S, bucket, want):
    sel = torch.arange(3, 3 + n)
    got = R._bucketed(sel, S, bucket)
    assert got.numel() == want
    assert torch.equal(got[:n], sel)
    assert (got[n:] == sel[0]).all()


@pytest.mark.parametrize("beam_size,on_card,want", [
    (2, True, R.BEAM_ROW_BUCKET), (3, True, R.BEAM_ROW_BUCKET),
    (1, True, 1), (2, False, 1)])
def test_only_a_beam_search_on_the_card_buckets(beam_size, on_card, want):
    feats = D.PreparedFeatures(*([None] * 8))._replace(
        fc=types.SimpleNamespace(is_cuda=on_card))
    assert R._row_bucket(feats, EvalConfig(beam_size=beam_size)) == want


# ---- on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


_KAR = {}


def _kar(dev, dtype="float32"):
    """Sub_GC_Kar at its published widths on the card, seeded weights."""
    if dtype not in _KAR:
        cfg = build_configs("Sub_GC_Kar")[0]
        if dtype != "float32":
            cfg = cfg.replace(compute_dtype=dtype, bf16_lstm_gates=True)
        p, _ = init_params_numpy(cfg, seed=25)
        _KAR[dtype] = cfg, params_from_numpy(p, dev)
    return _KAR[dtype]


# name: (compute dtype, EvalConfig, feature layout)
SEARCHES = {
    "kar_image_shared": ("float32", dict(beam_size=2),
                         dict(image_shared=True, images=16, slots=10)),
    "per_subgraph": ("float32", dict(beam_size=2),
                     dict(image_shared=False, images=16, slots=10)),
    "diverse_groups": ("float32", dict(beam_size=4, group_size=2,
                                       diversity_lambda=0.5),
                       dict(image_shared=True, images=16, slots=10)),
    "constraint_wu": ("float32", dict(beam_size=2, decoding_constraint=1,
                                      length_penalty="wu_0.9"),
                      dict(image_shared=True, images=16, slots=10)),
    "bf16_chain": ("bfloat16", dict(beam_size=2),
                   dict(image_shared=True, images=16, slots=10)),
    "fullgc_S1_B3": ("float32", dict(beam_size=3),
                     dict(image_shared=False, images=1, slots=1, N=36)),
    # 500 rows x 2 beams: the split-TF32 route, its weights prepared
    # inside the first graph
    "split_route": ("float32", dict(beam_size=2),
                    dict(image_shared=True, images=50, slots=10)),
}


def _card_feats(cfg, params, dev, seed=0, **layout):
    return _feats(cfg, params, n=36, N=layout.pop("N", 10), seed=seed,
                  device=dev, **layout)


def _counters():
    torch.cuda.synchronize()
    return ({n: getattr(A, n) for n in A.COUNTS.names},
            {n: getattr(GM, n) for n in GM.COUNTS.names})


def _advance(before, after):
    return [{k: a[k] - b[k] for k in a} for b, a in zip(before, after)]


def _same(got, want):
    for name, g, w in zip(B.BeamOut._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), f"{name} differs from the eager search's"


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_graph_replay_equals_eager_bit_for_bit(name):
    """Three calls of one key: eager, capture and replay, replay.  Every
    output equal to the eager call's bit for bit, every counter advanced
    as much; one chain kept; the split route's launches where its rows
    reach it."""
    dev = _card()
    dtype, ecfg, layout = SEARCHES[name]
    cfg, params = _kar(dev, dtype)
    ecfg = EvalConfig(**ecfg)
    feats = _card_feats(cfg, params, dev, **layout)
    outs, advances = [], []
    for _ in range(3):
        before = _counters()
        outs.append(B.beam_search(params, feats, cfg, ecfg))
        advances.append(_advance(before, _counters()))
    assert len(GR.SEARCHES) == 1
    for got, adv in zip(outs[1:], advances[1:]):
        _same(got, outs[0])
        assert adv == advances[0]
    attention, gemm = advances[0]
    steps = cfg.seq_length * ecfg.group_size
    shared = "SHARED_BF16_LAUNCHES" if dtype == "bfloat16" else "LAUNCHES"
    assert attention[shared] == attention["PROJECT_LAUNCHES"] == steps
    rows = feats.fc.shape[0] * ecfg.beam_size // ecfg.group_size
    split = dtype == "float32" and rows >= D.SPLIT_GEMM_MIN_ROWS
    assert gemm["GEMM_LAUNCHES"] == (7 * steps if split else 0)
    assert gemm["GEMM_WEIGHT_PREPS"] == (7 if split else 0)
    assert (name == "split_route") == split


def _eager(params, feats, cfg, ecfg):
    with torch.no_grad():
        return GR.drive(B._search(params, feats, cfg, ecfg))


@pytest.mark.cuda
def test_weight_updated_in_place_shows_in_the_next_replay():
    dev = _card()
    cfg, params = _kar(dev)
    feats = _card_feats(cfg, params, dev, image_shared=True, images=16,
                        slots=10)
    for _ in range(2):
        B.beam_search(params, feats, cfg, ECFG)   # eager, then capture
    w = params["decoder"]["logit"]["w"]
    saved = w.clone()
    try:
        with torch.no_grad():
            w.mul_(1.25)
        got = B.beam_search(params, feats, cfg, ECFG)
        _same(got, _eager(params, feats, cfg, ECFG))
        assert len(GR.SEARCHES) == 1
    finally:
        with torch.no_grad():
            w.copy_(saved)


@pytest.mark.cuda
def test_a_result_held_is_unchanged_by_the_next_call():
    dev = _card()
    cfg, params = _kar(dev)
    layout = dict(image_shared=True, images=16, slots=10)
    a = _card_feats(cfg, params, dev, seed=1, **layout)
    b = _card_feats(cfg, params, dev, seed=2, **layout)
    for _ in range(2):
        B.beam_search(params, a, cfg, ECFG)
    held = B.beam_search(params, a, cfg, ECFG)          # a replay
    copy = B.BeamOut(*(x.clone() for x in held))
    other = B.beam_search(params, b, cfg, ECFG)         # the next replay
    _same(held, copy)
    _same(other, _eager(params, b, cfg, ECFG))
    assert not torch.equal(other.all_ps, held.all_ps)


@pytest.mark.cuda
def test_a_second_shape_captures_beside_the_first():
    dev = _card()
    cfg, params = _kar(dev)
    shapes = [_card_feats(cfg, params, dev, seed=3, image_shared=True,
                          images=16, slots=10),
              _card_feats(cfg, params, dev, seed=4, image_shared=True,
                          images=8, slots=10)]
    want = [_eager(params, f, cfg, ECFG) for f in shapes]
    for _ in range(3):
        for f, w in zip(shapes, want):
            _same(B.beam_search(params, f, cfg, ECFG), w)
    assert len(GR.SEARCHES) == 2


@pytest.mark.cuda
def test_kept_counts_share_one_bucketed_key():
    """CTL-shaped dispatches (16 images x 32 region-set slots) with 49 to
    64 kept rows: the runner gathers 64 rows each time, so the second
    dispatch captures and the others replay one chain; each equals the
    eager search of the same gathered rows bit for bit at its kept rows,
    and the other rows are zero."""
    dev = _card()
    cfg, params = _kar(dev)
    feats = _card_feats(cfg, params, dev, seed=6, image_shared=True,
                        images=16, slots=32)
    S = feats.fc.shape[0]
    ecfg = EvalConfig(beam_size=2)
    for i, n in enumerate((49, 53, 60, 64)):
        keep = torch.zeros(S, dtype=torch.bool, device=dev)
        keep[torch.randperm(S, generator=torch.Generator().manual_seed(i))
             [:n].to(dev)] = True
        idx = torch.nonzero(keep).flatten()
        sel = R._bucketed(idx, S, R.BEAM_ROW_BUCKET)
        assert sel.numel() == 64
        want = _eager(params, R._take_rows(feats, sel), cfg, ecfg)
        got = R._decode(params, feats, keep, cfg, ecfg)
        assert torch.equal(got["seq"][idx], want.seq[:n])
        assert torch.equal(got["logprobs"][idx], want.logprobs[:n])
        assert not got["seq"][~keep].any()
        assert not got["logprobs"][~keep].any()
    assert len(GR.SEARCHES) == 1
