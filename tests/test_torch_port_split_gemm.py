"""The split-TF32 GEMM (``ops/gemm.py``, ``ops/csrc/gemm.cu``): the plain
version's accuracy, the wrapper's checks, the decoder's routing by device,
rows, dtype and gradient, and, on a card, the kernel against float64, its
launches on the decode paths and the tokens of an M-RNN dispatch.

This file imports neither jax nor the JAX package, so the ``cuda`` tests run
on a GPU machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_port_split_gemm.py

Accuracy: against a float64 product, the split product's largest error is
at most 4x that of torch's float32 ``x @ w`` on the same inputs (on the
card: cuBLAS with TF32 off), and at least 100x below one TF32 pass.
"""
import numpy as np
import pytest
import torch

from subgc_tpu_torch.config import EvalConfig, ModelConfig, build_configs
from subgc_tpu_torch.decode import beam as B
from subgc_tpu_torch.decode import greedy as G
from subgc_tpu_torch.models import decoder as D
from subgc_tpu_torch.models.params import init_params_numpy, params_from_numpy
from subgc_tpu_torch.ops import gemm as GM

K = 1000
TINY = dict(vocab_size=20, rnn_size=64, input_encoding_size=48,
            att_hid_size=32, gcn_dim=40, fc_feat_size=64, att_feat_size=80,
            embed_dim=20, num_obj_classes=30, num_rel_classes=10,
            obj_num=12, seq_length=5)


def _operands(M, N, k=K, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((M, k), generator=g) * 2 - 1            # an LSTM's h
    w = (torch.rand((k, N), generator=g) * 2 - 1) / k ** 0.5
    return x, w


def _max_err(y, ref):
    return (y.double() - ref).abs().max().item()


# ---- the plain version (CPU, tier 1)

@pytest.mark.parametrize("value,rounded", [
    (1.0, 1.0),
    (1.0 + 2 ** -11, 1.0 + 2 ** -10),           # a tie: away from zero
    (-1.0 - 2 ** -11, -1.0 - 2 ** -10),
    (1.0 + 2 ** -11 - 2 ** -23, 1.0),           # below the tie
    (1.0 + 3 * 2 ** -12, 1.0 + 2 ** -10),
    (-2.5, -2.5),
])
def test_tf32_round_is_cvt_rna(value, rounded):
    x = torch.tensor([value], dtype=torch.float32)
    r = GM.tf32_round(x)
    assert (r.view(torch.int32) & 0x1FFF).item() == 0
    assert r.item() == pytest.approx(rounded, rel=0, abs=2 ** -149)


@pytest.mark.parametrize("M", [1, 3, 65, 320])
def test_plain_split_product_keeps_float32_accuracy(M):
    N = 333                                     # ragged: no tile divides it
    x, w = _operands(M, N, seed=M)
    ref = x.double() @ w.double()
    err = _max_err(GM.split_gemm_ref(x, w), ref)
    f32 = _max_err(x @ w, ref)
    one = _max_err(GM.tf32_round(x) @ GM.tf32_round(w), ref)
    assert err <= 4 * f32, (err, f32)
    assert 100 * err <= one, (err, one)


def test_cpu_tensors_take_the_plain_version():
    x = torch.randn(7, 2, 48)                   # a beam layout [S, B, K]
    w = torch.randn(3 * 48, 40)[48:96]          # an LSTM's w_ih row slice
    b = torch.randn(40)
    y = GM.split_gemm(x, w, b)
    assert y.shape == (7, 2, 40)
    assert torch.equal(y, GM.split_gemm_ref(x, w, b))
    assert torch.equal(GM.split_gemm_ref(x, w, b),
                       GM.split_gemm_ref(x, w) + b)


@pytest.mark.parametrize("bad", ["dtype", "inner", "k_stride", "bias"])
def test_checks_refuse_what_the_kernel_does_not_take(bad):
    x, w, b = torch.randn(5, 16), torch.randn(16, 8), torch.randn(8)
    if bad == "dtype":
        x = x.double()
    elif bad == "inner":
        x = x[:, :15]
    elif bad == "k_stride":
        w = torch.randn(8, 16).t()              # K-major, not row-major
    else:
        b = b[:7]
    with pytest.raises((TypeError, ValueError)):
        GM.split_gemm(x, w, b)


@pytest.mark.parametrize("lead,split", [
    ((3,), False), ((160, 2), False),           # Full-GC's beam, Kar's
    ((D.SPLIT_GEMM_MIN_ROWS - 1,), False), ((D.SPLIT_GEMM_MIN_ROWS,), True),
    ((4864,), True), ((16000,), True),          # M-RNN: kept rows, all slots
])
def test_split_route_follows_the_rows(lead, split, monkeypatch):
    """On the card the decode step's rows choose the route: the beam
    decodes keep torch's products, the M-RNN greedy decode takes the
    kernel."""
    cfg = ModelConfig(compute_dtype="float32", **TINY)
    monkeypatch.setattr(D, "_on_card", lambda t: True)
    tok = torch.zeros(lead, dtype=torch.int64)
    with torch.no_grad():
        assert D._split_products({"decoder": {}}, (), tok, (), cfg,
                                 False) is split


# ---- the decoder's routing (CPU, tier 1)

def _tiny(dtype="float32", seed=0, S=6, n=12, requires_grad=False):
    cfg = ModelConfig(compute_dtype=dtype, **TINY)
    p, _ = init_params_numpy(cfg, seed=seed)
    params = params_from_numpy(p, "cpu", requires_grad)
    rng = np.random.RandomState(seed)
    G_ = 2
    x_obj = torch.from_numpy(np.maximum(rng.randn(G_, n, cfg.gcn_dim), 0)
                             .astype("f"))
    fc = torch.from_numpy(rng.randn(G_, S // G_, 2 * cfg.gcn_dim).astype("f"))
    oi = torch.from_numpy(rng.randint(0, n, (G_, S // G_, 4)))
    am = torch.ones((G_, S // G_, 4))
    with torch.no_grad():
        f = D.prepare_features_nodes(params, fc, x_obj, oi, am, cfg,
                                     image_shared=True)
    feats = D.PreparedFeatures(
        fc=f.fc.reshape(S, -1), att=None, p_att=None,
        mask=f.mask.reshape(S, -1), fc_ih=f.fc_ih.reshape(S, -1),
        att_img=f.att_img, p_att_img=f.p_att_img,
        img_ix=torch.arange(G_).repeat_interleave(S // G_))
    return cfg, params, feats


class _Count:
    def __init__(self):
        self.calls = 0

    def __call__(self, *args):
        self.calls += 1
        return GM.split_gemm(*args)


def _refuse(*args):
    raise AssertionError("split_gemm called on a route that keeps torch's "
                         "products")


def _decode(kind, params, feats, cfg):
    if kind == "sample":
        return G.sample(params, feats, cfg, EvalConfig(beam_size=1)).seq
    return B.beam_search(params, feats, cfg, EvalConfig(beam_size=2)).seq


@pytest.mark.parametrize("kind", ["sample", "beam"])
def test_cpu_decode_keeps_torch_products(kind, monkeypatch):
    cfg, params, feats = _tiny()
    assert D.cast_decoder_weights(params, cfg) is params
    before = _decode(kind, params, feats, cfg)
    monkeypatch.setattr(D, "split_gemm", _refuse)
    assert torch.equal(_decode(kind, params, feats, cfg), before)


@pytest.mark.parametrize("kind", ["sample", "beam"])
def test_card_decode_routes_seven_products_a_step(kind, monkeypatch):
    """With the tensors taken for a card's (the plain version runs in the
    kernel's place) and the row threshold at the tiny decode's rows, every
    step's seven products go through split_gemm on the weights as stored,
    and the tokens stay torch's."""
    cfg, params, feats = _tiny(seed=1)
    want = _decode(kind, params, feats, cfg)
    count = _Count()
    monkeypatch.setattr(D, "_on_card", lambda t: True)
    monkeypatch.setattr(D, "split_gemm", count)
    monkeypatch.setattr(D, "SPLIT_GEMM_MIN_ROWS", feats.fc.shape[0])
    assert D.cast_decoder_weights(params, cfg) is params
    got = _decode(kind, params, feats, cfg)
    assert count.calls == 7 * cfg.seq_length
    assert torch.equal(got, want)


@pytest.mark.parametrize("route", ["train", "autograd", "bfloat16", "rows"])
def test_card_routes_that_keep_torch_products(route, monkeypatch):
    cfg, params, feats = _tiny(
        "bfloat16" if route == "bfloat16" else "float32",
        requires_grad=route == "autograd")
    S = feats.fc.shape[0]
    monkeypatch.setattr(D, "_on_card", lambda t: True)
    monkeypatch.setattr(D, "split_gemm", _refuse)
    monkeypatch.setattr(D, "SPLIT_GEMM_MIN_ROWS", S + (route == "rows"))
    p = D.cast_decoder_weights(params, cfg)
    st = D.init_state(S, cfg, "cpu")
    tok = torch.zeros(S, dtype=torch.int64)
    with torch.enable_grad():
        lp, _, _ = D.decode_step(p, st, tok, feats, cfg,
                                 train=route == "train")
    assert lp.shape == (S, cfg.vocab_size + 1)
    assert lp.requires_grad == (route == "autograd")


# ---- on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,k,lead", [
    (4861, 4000, K, None), (4859, 9488, K, None),   # M-RNN, ragged M
    (320, 4000, K, (160, 2)), (320, 9488, K, (160, 2)),   # Kar's beam
    (3, 4000, K, None), (3, 9488, K, None),           # Full-GC
    (65, 333, K, None), (130, 77, 999, None),         # ragged N; K % 4 != 0
])
def test_kernel_keeps_float32_accuracy_on_card(M, N, k, lead):
    dev = _card()
    x, w = (t.to(dev) for t in _operands(M, N, k, seed=M + N))
    ref = x.double() @ w.double()
    before = GM.GEMM_LAUNCHES
    xl = x.reshape(lead + (k,)) if lead else x
    y = GM.split_gemm(xl, w).reshape(M, N)
    torch.cuda.synchronize()
    assert GM.GEMM_LAUNCHES == before + 1
    err, f32 = _max_err(y, ref), _max_err(x @ w, ref)
    one = _max_err(GM.tf32_round(x) @ GM.tf32_round(w), ref)
    assert err <= 4 * f32, (err, f32)
    assert 100 * err <= one, (err, one)
    assert torch.equal(GM.split_gemm(xl, w).reshape(M, N), y)     # repeat


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [False, True])
def test_weight_slices_and_bias_on_card(ragged):
    """A row slice of an LSTM's ``w_ih`` (3,000 rows, 4,000 floats apart)
    against the plain version, the bias joining in the epilogue exactly as
    a float32 add after the product; ``ragged``: N = 3,998, whose rows
    take the kernel's scalar loads."""
    dev = _card()
    N = 3998 if ragged else 4000
    x, w = (t.to(dev) for t in _operands(200, 4000, 3 * K, seed=5))
    ws = w[2 * K:, :N] if ragged else w[2 * K:]          # [1000, N]
    b = torch.randn(N, device=dev)
    xs = x[:, :K].contiguous()
    y = GM.split_gemm(xs, ws)
    yb = GM.split_gemm(xs, ws, b)
    torch.cuda.synchronize()
    assert torch.equal(yb, y + b)
    torch.testing.assert_close(y, GM.split_gemm_ref(xs, ws), rtol=0,
                               atol=1e-5)


def _card_tiny(seed=2):
    dev = _card()
    cfg, params, feats = _tiny(seed=seed)
    params = params_from_numpy(_np(params), dev)
    feats = D.PreparedFeatures(*(None if t is None else t.to(dev)
                                 for t in feats))
    return cfg, params, feats


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return tree.detach().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sample", "beam"])
@pytest.mark.parametrize("above", [True, False])
def test_seven_launches_a_step_on_card(kind, above, monkeypatch):
    """Seven launches a step at the row threshold, none below it."""
    cfg, params, feats = _card_tiny()
    rows = feats.fc.shape[0] * (2 if kind == "beam" else 1)   # [S, beams]
    monkeypatch.setattr(D, "SPLIT_GEMM_MIN_ROWS", rows + (not above))
    GM.reset_launch_counts()
    _decode(kind, params, feats, cfg)
    torch.cuda.synchronize()
    assert GM.GEMM_LAUNCHES == (7 * cfg.seq_length if above else 0)


def _top2_gaps(params, feats, cfg, seq):
    """[S, T]: the gap between the two best log-probs of each step of a
    greedy decode fed ``seq``'s tokens, on torch's products."""
    S, T = seq.shape
    st = D.init_state(S, cfg, seq.device)
    it = torch.zeros((S,), dtype=torch.int64, device=seq.device)
    gaps = []
    for t in range(T):
        lp, st, _ = D.decode_step(params, st, it, feats, cfg)
        top = lp.topk(2, dim=-1).values
        gaps.append(top[:, 0] - top[:, 1])
        it = seq[:, t]
    return torch.stack(gaps, 1)


@pytest.mark.cuda
def test_mrnn_dispatch_tokens_match_torch_on_card(monkeypatch):
    """The decode of one 16-image Sub_GC_MRNN dispatch at published widths
    (304 kept sub-graphs an image, 4,864 rows over the image-shared
    streams): the kernel's greedy tokens are torch.matmul's, but where a
    row first parts at a step whose two best log-probs (on torch's
    products) lie within 1e-5, a tie."""
    dev = _card()
    cfg = build_configs("Sub_GC_MRNN", vocab_size=9487)[0]
    p, _ = init_params_numpy(cfg, seed=7)
    params = params_from_numpy(p, dev)
    B_, Kp, n, N = 16, 304, 36, 10
    rng = np.random.RandomState(7)
    x_obj = torch.from_numpy(np.maximum(rng.randn(B_, n, cfg.gcn_dim), 0)
                             .astype("f") * 0.1).to(dev)
    fc = torch.from_numpy(rng.randn(B_, Kp, 2 * cfg.gcn_dim).astype("f")
                          * 0.1).to(dev)
    oi = torch.from_numpy(rng.randint(0, n, (B_, Kp, N))).to(dev)
    am = torch.from_numpy((rng.rand(B_, Kp, N) < 0.6).astype("f")).to(dev)
    am[..., 0] = 1.0
    with torch.no_grad():
        f = D.prepare_features_nodes(params, fc, x_obj, oi, am, cfg,
                                     image_shared=True)
    S = B_ * Kp
    feats = D.PreparedFeatures(
        fc=f.fc.reshape(S, -1), att=None, p_att=None,
        mask=f.mask.reshape(S, -1), fc_ih=f.fc_ih.reshape(S, -1),
        att_img=f.att_img, p_att_img=f.p_att_img,
        img_ix=torch.arange(B_, device=dev).repeat_interleave(Kp))
    ecfg = EvalConfig(beam_size=1)
    GM.reset_launch_counts()
    got = G.sample(params, feats, cfg, ecfg).seq
    torch.cuda.synchronize()
    assert GM.GEMM_LAUNCHES == 7 * cfg.seq_length
    with monkeypatch.context() as m:
        m.setattr(D, "_on_card", lambda t: False)      # torch's products
        want = G.sample(params, feats, cfg, ecfg).seq
        with torch.no_grad():
            gaps = _top2_gaps(params, feats, cfg, want)
    assert GM.GEMM_LAUNCHES == 7 * cfg.seq_length
    differ = (got != want).any(1)
    first = (got != want).int().argmax(1)
    rows = torch.nonzero(differ)[:, 0]
    assert bool((gaps[rows, first[rows]] < 1e-5).all()), (
        rows.tolist()[:10], gaps[rows, first[rows]].tolist()[:10])
