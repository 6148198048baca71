"""The split-TF32 GEMM (``ops/gemm.py``, ``ops/csrc/gemm.cu``): the plain
versions' accuracy (the product, and the weight's preparation into its
TF32 halves, transposed), the wrapper's checks, the decoder's routing by
device, rows, dtype and gradient and its one preparation of each weight a
decode call, and, on a card, the kernels against float64 and the plain
preparation, their launches on the decode paths and the tokens of an
M-RNN dispatch.

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


@pytest.mark.parametrize("K,N", [(1000, 40), (999, 7), (5, 3), (1, 1)])
def test_plain_preparation_is_the_tf32_halves_transposed(K, N):
    """``hi == tf32(w).T`` and ``lo == tf32(w - hi).T`` bit for bit, each
    row zero-padded to a multiple of 4 floats (16 bytes)."""
    w = torch.randn(K, N, generator=torch.Generator().manual_seed(K + N))
    pw = GM.prepare_weight(w)
    Kp = pw.planes.shape[-1]
    assert (pw.K, pw.N, pw.planes.shape) == (K, N, (2, N, Kp))
    assert Kp % 4 == 0 and K <= Kp < K + 4
    hi = GM.tf32_round(w)
    lo = GM.tf32_round(w - hi)
    bits = [t.contiguous().view(torch.int32) for t in
            (pw.planes[0, :, :K], hi.T, pw.planes[1, :, :K], lo.T)]
    assert torch.equal(bits[0], bits[1]) and torch.equal(bits[2], bits[3])
    assert not pw.planes[:, :, K:].any()


@pytest.mark.parametrize("lead", [(5,), (7, 2)])
def test_prepared_weight_is_the_raw_weight_bit_for_bit(lead):
    """``split_gemm`` on a prepared weight gives what it gives on the raw
    weight (a row slice of an LSTM's ``w_ih``), bias or not."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(lead + (48,), generator=g)
    w = torch.randn(3 * 48, 40, generator=g)[48:96]
    b = torch.randn(40, generator=g)
    pw = GM.prepare_weight(w)
    for bias in (None, b):
        y = GM.split_gemm(x, pw, bias)
        assert y.shape == lead + (40,)
        assert torch.equal(y, GM.split_gemm(x, w, bias))
    assert torch.equal(GM.split_gemm(x, pw, b), GM.split_gemm(x, pw) + b)


@pytest.mark.parametrize("bias", [False, True])
def test_empty_sum_is_the_bias_or_zeros(bias):
    """K = 0: the product is an empty sum, so the result is the bias, or
    zeros, through a raw or a prepared weight."""
    w, b = torch.zeros(0, 6), (torch.randn(6) if bias else None)
    want = (b.expand(4, 6) if bias else torch.zeros(4, 6))
    for ww in (w, GM.prepare_weight(w)):
        assert torch.equal(GM.split_gemm(torch.zeros(4, 0), ww, b), want)


def test_checks_refuse_a_prepared_weight_of_another_k():
    pw = GM.prepare_weight(torch.randn(16, 8))
    with pytest.raises(ValueError):
        GM.split_gemm(torch.randn(5, 15), pw)


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


@pytest.mark.parametrize("lead,train,route", [
    ((3,), False, "kernels"), ((160, 2), False, "kernels"),  # Full-GC, Kar
    ((D.SPLIT_GEMM_MIN_ROWS - 1,), False, "kernels"),
    ((D.SPLIT_GEMM_MIN_ROWS,), False, "split"),
    ((4864,), False, "split"), ((16000,), False, "split"),  # M-RNN
    ((16000,), True, "autograd"),               # training, even in no_grad
])
def test_split_route_follows_the_rows(lead, train, route, monkeypatch):
    """On the card the decode step's rows choose the route: the beam
    decodes keep torch's products, the M-RNN greedy decode (kept rows, or
    all keep slots) takes the kernel; training takes the autograd route
    at any rows, under ``torch.no_grad()`` too."""
    cfg = ModelConfig(compute_dtype="float32", **TINY)
    monkeypatch.setattr(D, "_on_card", lambda t: True)
    tok = torch.zeros(lead, dtype=torch.int64)
    with torch.no_grad():
        assert D._route({"decoder": {}}, (), tok, (), cfg, train) == route


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
    step's seven products go through split_gemm, on weights prepared once
    a call, and the tokens stay torch's."""
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


class _CountPreps:
    def __init__(self, prepare):
        self.prepare, self.calls = prepare, 0

    def __call__(self, w):
        self.calls += 1
        return self.prepare(w)


def _decode_out(kind, params, feats, cfg):
    if kind == "sample":
        out = G.sample(params, feats, cfg, EvalConfig(beam_size=1))
        return out.seq, out.logprobs
    out = B.beam_search(params, feats, cfg, EvalConfig(beam_size=2))
    return out.all_seqs, out.all_ps


@pytest.mark.parametrize("kind", ["sample", "beam"])
def test_card_decode_prepares_seven_weights_a_call(kind, monkeypatch):
    """On the ``split`` route a decode call prepares each of its seven
    weights once, not once a step, and each new call prepares them again;
    its tokens and log-probs are those of a decode whose products take the
    raw weights (and prepare them every product)."""
    cfg, params, feats = _tiny(seed=4)
    monkeypatch.setattr(D, "_on_card", lambda t: True)
    monkeypatch.setattr(D, "SPLIT_GEMM_MIN_ROWS", feats.fc.shape[0])
    count = _CountPreps(GM.prepare_weight)
    monkeypatch.setattr(D, "prepare_weight", count)
    got = _decode_out(kind, params, feats, cfg)
    assert count.calls == 7
    _decode_out(kind, params, feats, cfg)
    assert count.calls == 14
    monkeypatch.setattr(D, "prepare_weight", lambda w: w)     # raw weights
    want = _decode_out(kind, params, feats, cfg)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


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
@pytest.mark.parametrize("M,N,k,lead", [
    (4861, 4000, K, None), (4859, 9488, K, None),   # M-RNN, ragged M
    (320, 4000, K, (160, 2)), (320, 9488, K, (160, 2)),   # Kar's beam
    (3, 4000, K, None), (3, 9488, K, None),           # Full-GC
    (65, 333, K, None), (130, 77, 999, None),         # ragged N; K % 4 != 0
    (4750, 4000, K, None), (4890, 3998, K, None),     # mrnn_test's kept rows
    (16000, 4000, K, None),           # several tiles a persistent block
    (4860, 4000, 999, None), (1, 77, 999, None),
])
def test_prepared_kernel_keeps_float32_accuracy_on_card(M, N, k, lead):
    """The kernel on a prepared weight, as the decode calls it: float32
    accuracy against float64, the raw weight's result bit for bit, the
    bias as a float32 add after the product, a bitwise repeat, and an A
    whose rows are not 16 bytes apart (copied into a padded buffer)."""
    dev = _card()
    x, w = (t.to(dev) for t in _operands(M, N, k, seed=M + N + k))
    b = torch.randn(N, device=dev)
    ref = x.double() @ w.double()
    GM.reset_launch_counts()
    pw = GM.prepare_weight(w)
    xl = x.reshape(lead + (k,)) if lead else x
    y = GM.split_gemm(xl, pw).reshape(M, N)
    yb = GM.split_gemm(xl, pw, b).reshape(M, N)
    torch.cuda.synchronize()
    assert (GM.GEMM_LAUNCHES, GM.GEMM_WEIGHT_PREPS) == (2, 1)
    err, f32 = _max_err(y, ref), _max_err(x @ w, ref)
    one = _max_err(GM.tf32_round(x) @ GM.tf32_round(w), ref)
    assert err <= 4 * f32, (err, f32)
    assert 100 * err <= one, (err, one)
    assert torch.equal(yb, y + b)
    assert torch.equal(GM.split_gemm(xl, pw).reshape(M, N), y)    # repeat
    assert torch.equal(GM.split_gemm(xl, w).reshape(M, N), y)     # raw w
    wide = torch.zeros((M, k + 3), device=dev)
    wide[:, 1:k + 1] = x
    xs = wide[:, 1:k + 1]                 # rows k + 3 floats apart, offset
    assert torch.equal(GM.split_gemm(xs, pw), y)


@pytest.mark.cuda
@pytest.mark.parametrize("K_,N", [(1000, 4000), (999, 333), (3, 5)])
def test_preparation_matches_plain_on_card(K_, N):
    """The preparation kernel's planes are the plain version's, bit for
    bit, padding included; a weight row slice reads as it is stored."""
    dev = _card()
    w = torch.randn((K_ + 2, N + 1), generator=torch.Generator().manual_seed(
        K_))[1:K_ + 1, :N]
    pw = GM.prepare_weight(w.to(dev))
    torch.cuda.synchronize()
    ref = GM.prepare_weight_ref(w)
    assert pw.planes.shape == ref.planes.shape
    assert torch.equal(pw.planes.cpu().view(torch.int32),
                       ref.planes.view(torch.int32))


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


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True])
def test_empty_shapes_on_card(bias):
    """K = 0 launches the kernel, which writes the bias or zeros and
    prepares nothing; M = 0 launches nothing.  The counters move only
    where a kernel launched."""
    dev = _card()
    b = torch.randn(6, device=dev) if bias else None
    GM.reset_launch_counts()
    pw = GM.prepare_weight(torch.zeros((0, 6), device=dev))
    y = GM.split_gemm(torch.zeros((300, 0), device=dev), pw, b)
    torch.cuda.synchronize()
    assert torch.equal(y, b.expand(300, 6) if bias else
                       torch.zeros((300, 6), device=dev))
    assert (GM.GEMM_LAUNCHES, GM.GEMM_WEIGHT_PREPS) == (1, 0)
    w = torch.randn((40, 6), device=dev)
    y = GM.split_gemm(torch.zeros((0, 40), device=dev), w, b)
    torch.cuda.synchronize()
    assert y.shape == (0, 6)
    assert (GM.GEMM_LAUNCHES, GM.GEMM_WEIGHT_PREPS) == (1, 1)


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
    """Seven launches a step and seven weight preparations a call at the
    row threshold, none below it."""
    cfg, params, feats = _card_tiny()
    rows = feats.fc.shape[0] * (2 if kind == "beam" else 1)   # [S, beams]
    monkeypatch.setattr(D, "SPLIT_GEMM_MIN_ROWS", rows + (not above))
    GM.reset_launch_counts()
    _decode(kind, params, feats, cfg)
    torch.cuda.synchronize()
    assert GM.GEMM_LAUNCHES == (7 * cfg.seq_length if above else 0)
    assert GM.GEMM_WEIGHT_PREPS == (7 if above else 0)


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
    assert GM.GEMM_WEIGHT_PREPS == 7
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
