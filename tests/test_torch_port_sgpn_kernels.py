"""The sGPN test path's kernels (``ops/sgpn.py``, ``ops/csrc/sgpn.cu``): the
read-out max and the sub-graph NMS keep set.

On the CPU: the NMS kernel's algorithm written out in numpy (64-bit node
words, popcount IoU in float32, the greedy sweep in stable score order
stopped at ``max_keep``) held equal to the port's torch fixpoint
(``models/gpn.py::subgraph_nms``); the card's route, taken by device
alone, run with the torch ops faked into the launchers' place; the
launchers' refusals and their shared entry loader (``ops/_build.py``).
On a card (``cuda``): both kernels bit for bit against the port's CPU torch
path (which ``tests/test_torch_port_encoder_gpn.py`` and
``tests/test_nms_parallel.py`` hold to the JAX package), one launch of each
an encode, and the sGPN's test forward and NMS captured into a CUDA graph,
which no host sync survives.

This file imports neither jax nor the JAX package, so the ``cuda`` tests run
on a GPU machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_port_sgpn_kernels.py
"""
import ctypes
import functools

import numpy as np
import pytest
import torch

from subgc_tpu_torch.config import EvalConfig, ModelConfig, build_configs
from subgc_tpu_torch.graph import SceneGraph, SubgraphSet
from subgc_tpu_torch.models import gpn as G
from subgc_tpu_torch.models import subgc as SC
from subgc_tpu_torch.models.params import init_params_numpy, params_from_numpy
from subgc_tpu_torch.ops import sgpn as SG

N_OBJ = ModelConfig().obj_num           # 37: 36 detections and the dummy
TINY = dict(vocab_size=20, rnn_size=64, input_encoding_size=48,
            att_hid_size=32, gcn_dim=40, fc_feat_size=64, att_feat_size=80,
            embed_dim=20, num_obj_classes=30, num_rel_classes=10,
            seq_length=5)


# ---- sub-graph sets: (scores [B, S], obj_ind / att_mask [B, S, N],
# valid [B, S], threshold, max_keep)

def _lists(node_sets, N=N_OBJ):
    """Left-packed node lists of ``node_sets`` (one list of node lists an
    image), padded slots on the dummy node with mask 0."""
    B, S = len(node_sets), len(node_sets[0])
    oi = np.full((B, S, N), N - 1, np.int64)
    am = np.zeros((B, S, N), np.float32)
    for b, sets in enumerate(node_sets):
        for s, nodes in enumerate(sets):
            oi[b, s, :len(nodes)] = nodes
            am[b, s, :len(nodes)] = 1.0
    return oi, am


def _random(seed, B=3, S=64, pool=10, thres=0.55, max_keep=None):
    """Heavy overlap (a small node pool): long suppression chains."""
    rng = np.random.RandomState(seed)
    sets = [[list(rng.choice(pool, rng.randint(1, 8), replace=False))
             for _ in range(S)] for _ in range(B)]
    oi, am = _lists(sets)
    scores = rng.rand(B, S).astype(np.float32)
    scores[:, :S // 3] = scores[:, :1]                # a block of ties
    valid = rng.rand(B, S) > 0.1
    return scores, oi, am, valid, thres, max_keep or S


def _at_threshold(thres):
    """Pairs whose IoU is the threshold exactly in float32 (3/4 at 0.75;
    11/20 at 0.55, whose float32 quotient is float32(0.55)): not
    suppressed.  A pair just above it is."""
    if thres == 0.75:
        sets = [[0, 1, 2, 3], [0, 1, 2], [10, 11, 12, 13, 14],
                [10, 11, 12, 13]]                     # 3/4; 4/5
    else:
        sets = [list(range(16)), list(range(5, 20)), list(range(20, 32)),
                list(range(20, 31))]                  # 11/20; 11/12
    oi, am = _lists([sets])
    scores = np.array([[0.9, 0.8, 0.7, 0.6]], np.float32)
    return scores, oi, am, np.ones((1, 4), bool), thres, 4


def _edge_cases(seed=5):
    """Score ties, an all-invalid image, padded slots (the dummy node
    only, mask 1, invalid), duplicate and out-of-range node indices."""
    scores, oi, am, valid, _, _ = _random(seed, B=4, S=45, pool=8)
    scores[0] = 0.5                                   # every score tied
    valid[1] = False                                  # no valid sub-graph
    oi[2, 30:] = N_OBJ - 1                            # padded slots
    am[2, 30:] = 0.0
    am[2, 30:, 0] = 1.0
    valid[2, 30:] = False
    oi[3, :, 1] = oi[3, :, 0]                         # a duplicate index
    am[3, :, :2] = 1.0
    oi[3, ::5, 2] = N_OBJ + 3                         # outside the image
    oi[3, 1::5, 2] = -1
    am[3, :, 2] = 1.0
    return scores, oi, am, valid, 0.55, 7


CASES = {
    "random_055": lambda: _random(0),
    "random_075_keep10": lambda: _random(1, thres=0.75, max_keep=10),
    "random_020_keep1": lambda: _random(2, thres=0.2, max_keep=1),
    "random_095": lambda: _random(3, thres=0.95),
    "ragged_S37_keep3": lambda: _random(4, S=37, max_keep=3),
    "ragged_S100": lambda: _random(6, B=2, S=100, pool=14),
    "iou_at_075": lambda: _at_threshold(0.75),
    "iou_at_055": lambda: _at_threshold(0.55),
    "edges": _edge_cases,
}


def _torch(case, device="cpu"):
    scores, oi, am, valid, thres, max_keep = case
    return (*(torch.from_numpy(a).to(device) for a in (scores, oi, am,
                                                       valid)),
            thres, max_keep)


def _popcount(w):
    return int(w).bit_count()


def _numpy_nms(scores, obj_ind, att_mask, valid, thres, max_keep,
               n_obj=N_OBJ):
    """The kernel's algorithm: each sub-graph's node set a 64-bit word
    (bit i where a slot has mask != 0 and index i in [0, n_obj)), the
    sub-graphs in stable descending score order (invalid ones last), then
    the greedy sweep: a position is kept where it is valid and not yet
    suppressed, and clears every later one whose IoU, popc(a & b) over
    max(popc(a) + popc(b) - popc(a & b), 1) divided in float32, is above
    float32(thres); it stops after max_keep keeps.  Returns (keep_ind,
    keep_valid) as ``subgraph_nms`` does."""
    B, S = scores.shape
    max_keep = min(max_keep, S)
    thr = np.float32(thres)
    keep_ind = np.zeros((B, max_keep), np.int64)
    keep_valid = np.zeros((B, max_keep), bool)
    for b in range(B):
        s = np.where(valid[b], scores[b], np.float32(-np.inf))
        order = np.argsort(-s, kind="stable")
        words = []
        for i in order:
            w = 0
            for n, m in zip(obj_ind[b, i], att_mask[b, i]):
                if m != 0 and 0 <= n < n_obj:
                    w |= 1 << int(n)
            words.append(np.uint64(w))
        alive = valid[b][order].copy()
        kept = []
        for i in range(S):
            if len(kept) == max_keep:
                break
            if not alive[i]:
                continue
            kept.append(order[i])
            a = words[i]
            for j in range(i + 1, S):
                inter = _popcount(a & words[j])
                union = max(_popcount(a) + _popcount(words[j]) - inter, 1)
                if np.float32(inter) / np.float32(union) > thr:
                    alive[j] = False
        kept.sort()
        keep_ind[b, :len(kept)] = kept
        keep_valid[b, :len(kept)] = True
    return keep_ind, keep_valid


def _fixpoint(case, device="cpu"):
    scores, oi, am, valid, thres, max_keep = _torch(case, device)
    return G.subgraph_nms(scores, oi, am, valid, ModelConfig(), thres,
                          max_keep)


# ---- the kernels' algorithm and the card's route (CPU, tier 1)

@pytest.mark.parametrize("name", sorted(CASES))
def test_numpy_sweep_is_the_torch_fixpoint(name):
    case = CASES[name]()
    ki, kv = _fixpoint(case)
    want_ind, want_valid = _numpy_nms(*case)
    np.testing.assert_array_equal(kv.numpy(), want_valid)
    np.testing.assert_array_equal(ki.numpy(), want_ind)


@pytest.mark.parametrize("seed", range(4))
def test_numpy_sweep_on_seeded_sets(seed):
    rng = np.random.RandomState(100 + seed)
    case = _random(200 + seed, B=2, S=int(rng.randint(8, 90)),
                   pool=int(rng.randint(4, 30)),
                   thres=float(rng.choice([0.2, 0.55, 0.75, 0.95])),
                   max_keep=int(rng.choice([1, 3, 10, 1000])))
    ki, kv = _fixpoint(case)
    want_ind, want_valid = _numpy_nms(*case)
    np.testing.assert_array_equal(kv.numpy(), want_valid)
    np.testing.assert_array_equal(ki.numpy(), want_ind)


@pytest.mark.parametrize("thres", [0.75, 0.55])
def test_iou_at_the_threshold_is_not_suppressed(thres):
    ki, kv = _fixpoint(_at_threshold(thres))
    assert kv[0].tolist() == [True, True, True, False]
    assert ki[0, :3].tolist() == [0, 1, 2]


def _fake_kernels(monkeypatch, calls=None):
    """Take the card's route on CPU tensors, with the torch ops in the
    launchers' place; ``calls`` collects each launcher's name and the
    ``out`` the read-out launcher was given (and the NMS then keeps
    nothing)."""
    cfg = ModelConfig()

    def readout_max(x, obj_ind, att_mask, out):
        if calls is not None:
            calls.append(("readout_max", out))
        return out.copy_(G.masked_max(
            x, G.node_membership(obj_ind, att_mask, x.shape[-2])))

    def nms_keep_sorted(order, obj_ind, att_mask, valid, thres, max_keep,
                        n_obj):
        if calls is not None:         # recorded, not swept
            calls.append(("nms_keep_sorted", None))
            return torch.zeros(order.shape, dtype=torch.bool)
        return G._keep_sorted_torch(order, obj_ind, att_mask, valid,
                                    cfg.replace(obj_num=n_obj), thres,
                                    max_keep, True)

    monkeypatch.setattr(G, "_on_card", lambda t: True)
    monkeypatch.setattr(SG, "readout_max", readout_max)
    monkeypatch.setattr(SG, "nms_keep_sorted", nms_keep_sorted)


@pytest.mark.parametrize("name", sorted(CASES))
def test_card_route_is_the_torch_path(name, monkeypatch):
    """gpn_test_forward and subgraph_nms down the card's route (the max
    written into its half of a read-out, one NMS span, the sweep in both
    ``parallel`` settings) with the torch ops in the launchers' place,
    against the CPU route."""
    cfg = ModelConfig(**TINY, obj_num=N_OBJ)
    params = params_from_numpy(init_params_numpy(cfg, seed=3)[0], "cpu")
    scores, oi, am, valid, thres, max_keep = _torch(CASES[name]())
    rng = np.random.RandomState(2)
    x = torch.from_numpy(np.maximum(rng.randn(oi.shape[0], N_OBJ,
                                              cfg.gcn_dim), 0).astype("f"))
    x[0, 3, 5] = -0.0                     # member + 0.0 is +0.0
    want = G.gpn_test_forward(params, x, oi, am, cfg)
    want_nms = G.subgraph_nms(want.scores, oi, am, valid, cfg, thres,
                              max_keep)
    _fake_kernels(monkeypatch)
    got = G.gpn_test_forward(params, x, oi, am, cfg)
    assert torch.equal(got.read_out.view(torch.int32),
                       want.read_out.view(torch.int32))
    assert torch.equal(got.scores, want.scores)
    for parallel in (True, False):
        got_nms = G.subgraph_nms(got.scores, oi, am, valid, cfg, thres,
                                 max_keep, parallel=parallel)
        for a, b in zip(got_nms, want_nms):
            assert torch.equal(a, b)
    one = G.subgraph_nms(got.scores[0], oi[0], am[0], valid[0], cfg, thres,
                         max_keep)                    # the 1-D form
    assert torch.equal(one[0], want_nms[0][0])
    assert torch.equal(one[1], want_nms[1][0])


@pytest.mark.parametrize("what", ["65_nodes", "16385_subgraphs",
                                  "sequential"])
def test_card_route_is_taken_by_device_alone(what, monkeypatch):
    """On the card the launchers get every call, whatever the node count,
    the sub-graph count or ``parallel`` (they raise on what they do not
    take); no input sends the card back to the torch ops."""
    cfg = ModelConfig(**TINY, obj_num=N_OBJ)
    params = params_from_numpy(init_params_numpy(cfg, seed=3)[0], "cpu")
    n_obj = 65 if what == "65_nodes" else N_OBJ
    S = 16385 if what == "16385_subgraphs" else 6
    oi = torch.randint(0, n_obj, (1, S, 4))
    am = torch.ones(1, S, 4)
    x = torch.rand(1, n_obj, cfg.gcn_dim)
    calls = []
    _fake_kernels(monkeypatch, calls)
    cfg = cfg.replace(obj_num=n_obj)
    out = G.gpn_test_forward(params, x, oi, am, cfg)
    G.subgraph_nms(out.scores, oi, am, torch.ones(1, S, dtype=bool), cfg,
                   0.5, 3, parallel=what != "sequential")
    assert [c[0] for c in calls] == ["readout_max", "nms_keep_sorted"]


def test_read_out_half_is_written_in_place(monkeypatch):
    """The card's route hands the read-out launcher the max half of the
    read-out itself, a view whose rows lie one stride apart."""
    cfg = ModelConfig(**TINY, obj_num=N_OBJ)
    params = params_from_numpy(init_params_numpy(cfg, seed=3)[0], "cpu")
    _, oi, am, _, _, _ = _random(7, B=2, S=5)
    oi, am = torch.from_numpy(oi), torch.from_numpy(am)
    calls = []
    _fake_kernels(monkeypatch, calls)
    got = G.gpn_test_forward(params, torch.rand(2, N_OBJ, cfg.gcn_dim), oi,
                             am, cfg)
    (name, out), = calls
    L = cfg.gcn_dim
    assert name == "readout_max" and out.data_ptr() == got.read_out.data_ptr()
    assert out.shape == (2, 5, L) and out.stride() == (5 * 2 * L, 2 * L, 1)
    assert SG._row_stride(out, (2,), 5, L) == 2 * L
    assert SG._row_stride(out.transpose(0, 1), (5,), 2, L) is None


@pytest.mark.parametrize("launcher", ["readout_max", "nms_keep_sorted"])
def test_launchers_refuse_tensors_off_the_card(launcher):
    """The launchers hold no plain version: a CPU tensor is refused."""
    _, oi, am, valid, _, _ = _random(12, B=1, S=8)
    oi, am = torch.from_numpy(oi), torch.from_numpy(am)
    with pytest.raises(ValueError, match="no kernel for cpu"):
        if launcher == "readout_max":
            SG.readout_max(torch.rand(1, N_OBJ, 8), oi, am)
        else:
            SG.nms_keep_sorted(torch.arange(8)[None], oi, am,
                               torch.from_numpy(valid), 0.5, 3, N_OBJ)


@pytest.mark.parametrize("lib", ["gemm", "sgpn"])
def test_first_entry_lookup_loads_once_across_threads(lib, monkeypatch):
    """Threads racing to a library's first entry lookup
    (``_build.entry``) load it and set the entry's signature once."""
    import threading
    import time
    from subgc_tpu_torch.ops import _build
    loads = []

    class Lib:
        def __getattr__(self, name):
            return type("Entry", (), {})()

    def slow_load(name):
        loads.append(name)
        time.sleep(0.05)              # a build takes a while
        return Lib()

    monkeypatch.setattr(_build, "load", slow_load)
    monkeypatch.setattr(_build, "_entries", {})
    got, start = [], threading.Barrier(8)

    def work():
        start.wait()
        for _ in range(5):
            got.append(_build.entry(lib, "an_entry", [ctypes.c_int]))

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert loads == [lib]
    assert len(got) == 40 and len({id(f) for f in got}) == 1
    assert got[0].argtypes == [ctypes.c_int]
    assert got[0].restype is ctypes.c_int


# ---- on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _bank_images():
    """The test cells' dispatch: ``chip_smoke.py``'s phase 30 inputs, 16
    images x 1,024 sub-graph slots of 37 nodes, L = 1,024."""
    import chip_smoke
    x, oi, am, valid, scores = chip_smoke.sgpn_inputs(N_OBJ, 1024, seed=11)
    return scores, oi, am, valid, x


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_nms_kernel_is_the_cpu_torch_path(name):
    dev = _card()
    case = CASES[name]()
    SG.reset_launch_counts()
    ki, kv = _fixpoint(case, dev)
    torch.cuda.synchronize()
    assert SG.NMS_LAUNCHES == 1
    want_ind, want_valid = _fixpoint(case)
    assert torch.equal(kv.cpu(), want_valid)
    assert torch.equal(ki.cpu(), want_ind)
    scores, oi, am, valid, thres, max_keep = _torch(case, dev)
    ki, kv = G.subgraph_nms(scores, oi, am, valid, ModelConfig(), thres,
                            max_keep, parallel=False)   # the same launch
    torch.cuda.synchronize()
    assert SG.NMS_LAUNCHES == 2
    assert torch.equal(kv.cpu(), want_valid)
    assert torch.equal(ki.cpu(), want_ind)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_readout_kernel_is_the_cpu_torch_path(name):
    dev = _card()
    _, oi, am, _, _, _ = CASES[name]()
    oi, am = torch.from_numpy(oi), torch.from_numpy(am)
    rng = np.random.RandomState(len(name))
    x = torch.from_numpy(rng.randn(oi.shape[0], N_OBJ, 300).astype("f"))
    x[0, 0, :4] = torch.tensor([-0.0, float("inf"), -float("inf"), 1e25])
    want = G.masked_max(x, G.node_membership(oi, am, N_OBJ))
    SG.reset_launch_counts()
    got = SG.readout_max(x.to(dev), oi.to(dev), am.to(dev)).cpu()
    assert SG.READOUT_LAUNCHES == 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("thres,max_keep", [(0.75, 10), (0.55, 1000)],
                         ids=["kar_test", "mrnn_test"])
def test_kernels_at_the_cells_shapes(thres, max_keep):
    """16 images x 1,024 sub-graphs of 37 nodes, L = 1,024, at each test
    cell's threshold and keep."""
    dev = _card()
    scores, oi, am, valid, x = _bank_images()
    cfg = ModelConfig()
    args = [torch.from_numpy(a) for a in (scores, oi, am, valid)]
    want = G.subgraph_nms(*args, cfg, thres, max_keep)
    got = G.subgraph_nms(*(a.to(dev) for a in args), cfg, thres, max_keep)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu(), want[0])
    xt = torch.from_numpy(x)
    out = SG.readout_max(xt.to(dev), args[1].to(dev), args[2].to(dev)).cpu()
    for b in range(x.shape[0]):             # an image at a time: 155 MB
        want = G.masked_max(xt[b], G.node_membership(args[1][b], args[2][b],
                                                     N_OBJ))
        assert torch.equal(out[b], want)


@pytest.mark.cuda
def test_read_out_and_scores_are_the_torch_routes_on_card(monkeypatch):
    """On the card the kernel route's read-out and sGPN scores are the
    torch route's bit for bit: the max half by the kernel, the mean half
    and the scores by the same torch ops."""
    dev = _card()
    cfg = ModelConfig(**TINY, obj_num=N_OBJ)
    params = params_from_numpy(init_params_numpy(cfg, seed=3)[0], dev)
    _, oi, am, _, _, _ = _random(8, B=4, S=96)
    rng = np.random.RandomState(8)
    x = torch.from_numpy(np.maximum(rng.randn(4, N_OBJ, cfg.gcn_dim),
                                    0).astype("f")).to(dev)
    oi, am = torch.from_numpy(oi).to(dev), torch.from_numpy(am).to(dev)
    SG.reset_launch_counts()
    got = G.gpn_test_forward(params, x, oi, am, cfg)
    assert SG.READOUT_LAUNCHES == 1
    monkeypatch.setattr(G, "_on_card", lambda t: False)
    want = G.gpn_test_forward(params, x, oi, am, cfg)
    assert SG.READOUT_LAUNCHES == 1
    assert torch.equal(got.read_out, want.read_out)
    assert torch.equal(got.scores, want.scores)


@pytest.mark.cuda
def test_one_launch_of_each_kernel_an_encode():
    dev = _card()
    cfg, ecfg, _ = build_configs("Sub_GC_Kar", model=TINY)
    params_np, state = init_params_numpy(cfg, seed=4)
    params = params_from_numpy(params_np, dev)
    rng = np.random.RandomState(4)
    B, S, N, K = 3, 40, cfg.obj_num, cfg.rel_num
    graph = SceneGraph(
        obj_fmap=torch.rand(B, N, cfg.att_feat_size),
        obj_dist=torch.rand(B, N, cfg.num_obj_classes),
        rel_ind=torch.from_numpy(rng.randint(0, N - 1, (B, K, 2))),
        pred_dist=torch.rand(B, K, cfg.num_rel_classes))
    _, oi, am, valid, _, _ = _random(9, B=B, S=S)
    subs = SubgraphSet(obj_ind=torch.from_numpy(oi),
                       pred_ind=torch.full((B, S, K), K - 1),
                       att_mask=torch.from_numpy(am),
                       valid=torch.from_numpy(valid))
    to = functools.partial(torch.Tensor.to, device=dev)
    SG.reset_launch_counts()
    card = SC.encode_images_batched(params, state,
                                    SceneGraph(*map(to, graph)),
                                    SubgraphSet(*map(to, subs)), cfg, ecfg)
    torch.cuda.synchronize()
    assert (SG.READOUT_LAUNCHES, SG.NMS_LAUNCHES) == (1, 1)
    cpu = SC.encode_images_batched(params_from_numpy(params_np, "cpu"),
                                   state, graph, subs, cfg, ecfg)
    assert torch.equal(card.keep_ind.cpu(), cpu.keep_ind)
    assert torch.equal(card.keep_valid.cpu(), cpu.keep_valid)


@pytest.mark.cuda
def test_sgpn_and_nms_capture_into_a_cuda_graph():
    """No host sync is left: the sGPN's test forward and NMS capture into
    one CUDA graph, whose replay gives the eager outputs."""
    dev = _card()
    cfg = ModelConfig(**TINY, obj_num=N_OBJ)
    params = params_from_numpy(init_params_numpy(cfg, seed=5)[0], dev)
    _, oi, am, valid, thres, max_keep = _random(10, B=4, S=200, pool=12)
    oi, am, valid = (torch.from_numpy(a).to(dev) for a in (oi, am, valid))
    x = torch.rand(4, N_OBJ, cfg.gcn_dim, device=dev)

    def encode():
        out = G.gpn_test_forward(params, x, oi, am, cfg)
        return (out.read_out, *G.subgraph_nms(out.scores, oi, am, valid,
                                              cfg, thres, max_keep))

    with torch.no_grad():
        eager = encode()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            encode()                        # warm-up off the default stream
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        SG.reset_launch_counts()
        with torch.cuda.graph(graph):
            captured = encode()
        assert (SG.READOUT_LAUNCHES, SG.NMS_LAUNCHES) == (1, 1)
        graph.replay()
        torch.cuda.synchronize()
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _card()
    _, oi, am, valid, _, _ = _random(11, B=1, S=8)
    oi, am = torch.from_numpy(oi).to(dev), torch.from_numpy(am).to(dev)
    with pytest.raises(TypeError):
        SG.readout_max(torch.rand(1, N_OBJ, 8, device=dev,
                                  dtype=torch.float64), oi, am)
    with pytest.raises(ValueError):
        SG.readout_max(torch.rand(1, 65, 8, device=dev), oi, am)
    with pytest.raises(ValueError):                   # rows not one stride
        SG.readout_max(torch.rand(1, N_OBJ, 8, device=dev), oi, am,
                       out=torch.empty(1, 8, 8, device=dev).transpose(1, 2))
    order = torch.arange(8, device=dev)[None]
    with pytest.raises(ValueError):
        SG.nms_keep_sorted(order, oi, am, torch.from_numpy(valid).to(dev),
                           0.5, 3, 65)
