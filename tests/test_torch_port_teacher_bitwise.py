"""``forward_teacher`` and its backward held bit for bit to a transcription
of the decode step's autograd route in plain torch expressions, at tiny
widths on the CPU: the loss and every decoder leaf's gradient equal under
``torch.equal``.

The transcription spells each sum with the association the route has, so
that a changed op, a reordered sum or a folded bias fails here at its first
changed bit.  Float32 attends over per-row streams with dropout from a
seeded generator; bfloat16 over image-shared streams with
``bf16_lstm_gates`` and ``bf16_residuals`` (its LSTM backward transcribed
too).  The features are prepared by the decoder's own functions on both
sides, under autograd, so that their leaves' gradients are compared too.

This file imports neither jax nor the JAX package.
"""
import numpy as np
import pytest
import torch

from subgc_tpu_torch.config import ModelConfig
from subgc_tpu_torch.models import decoder as D
from subgc_tpu_torch.models.params import init_params_numpy, params_from_numpy

TINY = dict(vocab_size=20, rnn_size=64, input_encoding_size=48,
            att_hid_size=32, gcn_dim=40, fc_feat_size=64, att_feat_size=80,
            embed_dim=20, num_obj_classes=30, num_rel_classes=10,
            obj_num=12, seq_length=5, drop_prob_lm=0.5)
BF = torch.bfloat16
F32 = torch.float32


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, so that every product sums in one order on
    both sides.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the transcription

def _cast_weights(dec, bf16_gates):
    """The decoder's matmul weights (and the LSTM biases under bf16 gates)
    in bf16, in the order the decoder casts them."""
    dec = dict(dec)
    dec["embed"] = dec["embed"].to(BF)
    for k in ["fc_embed1", "fc_embed2", "att_embed", "ctx2att", "h2att",
              "alpha_net", "logit"]:
        dec[k] = {**dec[k], "w": dec[k]["w"].to(BF)}
    lstm = ("w", "b") if bf16_gates else ("w",)
    for k in ["att_lstm", "lang_lstm"]:
        dec[k] = {kk: v.to(BF) if kk.startswith(lstm) else v
                  for kk, v in dec[k].items()}
    return dec


class _CellB16R(torch.autograd.Function):
    """The bf16-gate LSTM nonlinearity with bf16 backward residuals."""

    @staticmethod
    def forward(ctx, g, c):
        i, f, gg, o = torch.chunk(g, 4, dim=-1)
        i = 1 / (1 + torch.exp(-i))
        f = 1 / (1 + torch.exp(-f))
        o = 1 / (1 + torch.exp(-o))
        gg = torch.tanh(gg)
        c2 = f.float() * c + (i * gg).float()
        h2 = (o.float() * torch.tanh(c2)).to(BF)
        ctx.save_for_backward(g.to(BF), c.to(BF), c2.to(BF))
        return h2, c2

    @staticmethod
    def backward(ctx, dh2, dc2):
        g, c, c2 = (t.float() for t in ctx.saved_tensors)
        dh2, dc2 = dh2.float(), dc2.float()
        gi, gf, gg_, go = torch.chunk(g, 4, dim=-1)
        i = torch.sigmoid(gi)
        f = torch.sigmoid(gf)
        o = torch.sigmoid(go)
        gg = torch.tanh(gg_)
        tc2 = torch.tanh(c2)
        do = dh2 * tc2
        dc = dc2 + dh2 * o * (1.0 - tc2 * tc2)
        dg = torch.cat([dc * gg * (i * (1.0 - i)),
                        dc * c * (f * (1.0 - f)),
                        dc * i * (1.0 - gg * gg),
                        do * (o * (1.0 - o))], dim=-1)
        return dg.to(BF), dc * f


def _cell_f32(g, c):
    i, f, gg, o = torch.chunk(g, 4, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f)
    o = torch.sigmoid(o)
    gg = torch.tanh(gg)
    c2 = f * c + i * gg
    return o * torch.tanh(c2), c2


def _drop(x, gen, rate):
    keep = torch.rand(x.shape, generator=gen) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _teacher_f32(params, feats, seq, cfg, gen):
    """Float32, per-row streams: the step's products and sums as the
    autograd route spells them."""
    d = params["decoder"]
    R, rate = cfg.rnn_size, cfg.drop_prob_lm
    S, T = seq.shape[0], seq.shape[1] - 1
    a, la = d["att_lstm"], d["lang_lstm"]
    z = torch.zeros((S, R))
    h_att, c_att, h_lang, c_lang = z, z, z, z
    xt = _drop(torch.relu(d["embed"][seq[:, :T].T]), gen, rate)
    xt_ih = (xt.reshape(T * S, -1) @ a["w_ih"][2 * R:]).reshape(T, S, -1)
    lps = []
    for t in range(T):
        gx = h_lang @ a["w_ih"][:R] + feats.fc_ih + xt_ih[t] + a["b_ih"]
        h_att, c_att = _cell_f32(gx + (h_att @ a["w_hh"] + a["b_hh"]),
                                 c_att)
        att_h = h_att @ d["h2att"]["w"] + d["h2att"]["b"]
        dot = torch.tanh(feats.p_att + att_h[:, None, :])
        e = (dot @ d["alpha_net"]["w"] + d["alpha_net"]["b"])[..., 0]
        w = torch.softmax(e, dim=-1)
        w = w * feats.mask
        w = w / w.sum(-1, keepdim=True)
        att_res = (w[:, None, :] @ feats.att)[:, 0]
        gx = (att_res @ la["w_ih"][:R]) + (h_att @ la["w_ih"][R:]) \
            + la["b_ih"]
        h_lang, c_lang = _cell_f32(gx + (h_lang @ la["w_hh"] + la["b_hh"]),
                                   c_lang)
        out = _drop(h_lang, gen, rate)
        lps.append(torch.log_softmax(out @ d["logit"]["w"] + d["logit"]["b"],
                                     dim=-1))
    return torch.stack(lps, 1)


def _teacher_bf16_gates(params, feats, seq, cfg, gen):
    """bfloat16 with bf16 gates and residuals, image-shared streams: each
    product rounded to bf16, the gate sums in bf16, ``b_hh`` after the
    recurrent product."""
    d = _cast_weights(params["decoder"], True)
    R, rate = cfg.rnn_size, cfg.drop_prob_lm
    S, T = seq.shape[0], seq.shape[1] - 1
    a, la = d["att_lstm"], d["lang_lstm"]
    h_att = h_lang = torch.zeros((S, R), dtype=BF)
    c_att = c_lang = torch.zeros((S, R))
    xt = _drop(torch.relu(d["embed"][seq[:, :T].T]), gen, rate)
    xt_ih = (xt.reshape(T * S, -1) @ a["w_ih"][2 * R:]).reshape(T, S, -1)
    B, n = feats.att_img.shape[:2]
    K = S // B
    lps = []
    for t in range(T):
        gx = h_lang @ a["w_ih"][:R] + feats.fc_ih + xt_ih[t] + a["b_ih"]
        h_att, c_att = _CellB16R.apply(gx + h_att @ a["w_hh"] + a["b_hh"],
                                       c_att)
        att_h = ((h_att @ d["h2att"]["w"]).float()
                 + d["h2att"]["b"]).to(BF)
        dot = torch.tanh(feats.p_att_img[:, None]
                         + att_h.reshape(B, K, 1, -1))
        e = ((dot @ d["alpha_net"]["w"]).float()
             + d["alpha_net"]["b"])[..., 0]
        w = torch.softmax(e, dim=-1)
        w = w * feats.mask.reshape(B, K, n)
        w = w / w.sum(-1, keepdim=True)
        att_res = (w.to(BF).float() @ feats.att_img.float()).reshape(S, -1)
        gx = (att_res.to(BF) @ la["w_ih"][:R]) + (h_att @ la["w_ih"][R:]) \
            + la["b_ih"]
        h_lang, c_lang = _CellB16R.apply(
            gx + h_lang @ la["w_hh"] + la["b_hh"], c_lang)
        out = _drop(h_lang, gen, rate)
        logits = (out @ d["logit"]["w"]).float() + d["logit"]["b"]
        lps.append(torch.log_softmax(logits, dim=-1))
    return torch.stack(lps, 1)


# ---- the comparison

def _case(dtype):
    cfg = ModelConfig(compute_dtype=dtype, bf16_lstm_gates=dtype != "float32",
                      bf16_residuals=dtype != "float32", **TINY)
    p, _ = init_params_numpy(cfg, seed=3)
    params = params_from_numpy(p, "cpu", requires_grad=True)
    rng = np.random.RandomState(3)
    S, N, B = 6, 4, 2
    L = cfg.gcn_dim
    fc = torch.from_numpy(rng.randn(S, 2 * L).astype("f"))
    seq = torch.from_numpy(rng.randint(1, cfg.vocab_size + 1,
                                       (S, cfg.seq_length + 2)))
    if dtype == "float32":
        att = torch.from_numpy(np.maximum(rng.randn(S, N, L), 0).astype("f"))
        mask = torch.from_numpy((rng.rand(S, N) < 0.7).astype("f"))
        mask[:, 0] = 1.0

        def feats():
            return D.prepare_features_bn(params, fc, att, mask, cfg)[0]
    else:
        x_obj = torch.from_numpy(np.maximum(rng.randn(B, cfg.obj_num, L), 0)
                                 .astype("f"))
        mem = torch.from_numpy((rng.rand(S, cfg.obj_num) < 0.5).astype("f"))
        mem[:, 0] = 1.0

        def feats():
            return D.prepare_features_shared_train(params, fc, x_obj, mem,
                                                   cfg)
    return cfg, params, seq, feats


def _named_leaves(tree, prefix="decoder"):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}.{k}")
    else:
        yield prefix, tree


def _loss_and_grads(params, teacher):
    for _, t in _named_leaves(params["decoder"]):
        t.grad = None
    lp = teacher()
    loss = -lp.mean()
    loss.backward()
    return loss.detach(), {k: t.grad for k, t in
                           _named_leaves(params["decoder"])}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_teacher_and_backward_equal_the_transcription(dtype):
    cfg, params, seq, feats = _case(dtype)
    transcribed = (_teacher_f32 if dtype == "float32"
                   else _teacher_bf16_gates)

    def port():
        return D.forward_teacher(params, feats(), seq, cfg, train=True,
                                 generator=torch.Generator().manual_seed(9))

    def plain():
        return transcribed(params, feats(), seq, cfg,
                           torch.Generator().manual_seed(9))

    loss, grads = _loss_and_grads(params, port)
    want_loss, want = _loss_and_grads(params, plain)
    assert torch.isfinite(loss) and loss > 0
    assert torch.equal(loss, want_loss), (loss.item(), want_loss.item())
    assert grads.keys() == want.keys()
    got_any = 0
    for k in want:
        assert (grads[k] is None) == (want[k] is None), k
        if want[k] is not None:
            assert torch.equal(grads[k], want[k]), k
            got_any += 1
    assert got_any >= 18        # the step's and the features' leaves
