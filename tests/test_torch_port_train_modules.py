"""The port's training modules held against the JAX package, piece by
piece, on the CPU at tiny widths: BatchNorm in train mode, the sGPN
training branch and its BCE loss, ``forward_teacher`` on both paths with
scheduled sampling held to its rule, the dropout rule, ``bf16_residuals``,
and the inference entry points without autograd.

Dropout is off on both sides for the comparisons (``drop_prob_lm=0`` and
no rng / generator: the JAX package's teacher-forced decoder draws its
dropout from key 0 even without an rng, so its rate is set to 0).
Tolerances: BatchNorm and sGPN atol 1e-6, logprobs atol 1e-5 (float32
summation order); chosen sub-graphs and fed tokens exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subgc_tpu.config import ModelConfig as JModelConfig
from subgc_tpu.models import decoder as JD
from subgc_tpu.models import encoder as JE
from subgc_tpu.models import gpn as JG
from subgc_tpu_torch.config import EvalConfig, ModelConfig
from subgc_tpu_torch.decode.beam import beam_search
from subgc_tpu_torch.decode.greedy import sample
from subgc_tpu_torch.graph import (SceneGraph, SubgraphSet,
                                   make_scene_graph, pad_subgraph_set,
                                   subgraphs_from_masks, to_device)
from subgc_tpu_torch.models import decoder as D
from subgc_tpu_torch.models import encoder as E
from subgc_tpu_torch.models import gpn as G
from subgc_tpu_torch.models.params import (init_params, init_params_numpy,
                                           params_from_numpy)
from subgc_tpu_torch.models.subgc import encode_images_batched

from .test_torch_port_train import one_thread  # noqa: F401

WIDTHS = dict(vocab_size=50, seq_length=16, rnn_size=64,
              input_encoding_size=48, att_hid_size=32, gcn_dim=40,
              fc_feat_size=64, att_feat_size=80, embed_dim=20,
              num_obj_classes=30, num_rel_classes=10, drop_prob_lm=0.0)
JCFG = JModelConfig(**WIDTHS)


def _port_cfg(jcfg):
    return ModelConfig(**{f: getattr(jcfg, f)
                          for f in ModelConfig.__dataclass_fields__})


def _models(jcfg, seed=0):
    """(numpy params, numpy state, port params, port state): the port's
    numpy init, which has the JAX package's layout, feeds both packages."""
    params, state = init_params_numpy(_port_cfg(jcfg), seed, n_obj_names=30,
                                      n_pred_names=10)
    return params, state, params_from_numpy(params, "cpu"), \
        params_from_numpy(state, "cpu")


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


@pytest.mark.parametrize("masked", [False, True])
def test_batch_norm_train_matches_jax(masked):
    """Batch statistics (biased variance), the unbiased running update and
    the masked statistics over real rows only, divided by mask.sum()."""
    rng = np.random.RandomState(1)
    x = (rng.randn(60, 24) * 2 + 0.5).astype("f")
    p = {"scale": rng.uniform(0.5, 1.5, 24).astype("f"),
         "bias": rng.randn(24).astype("f")}
    s = {"mean": rng.normal(0, 0.5, 24).astype("f"),
         "var": rng.uniform(0.2, 2.0, 24).astype("f")}
    mask = (rng.rand(60) > 0.4).astype("f") if masked else None
    jy, js = JE.batch_norm_1d(jnp.asarray(x), p, s, True,
                              mask=None if mask is None else jnp.asarray(mask))
    ty, ts = E.batch_norm_1d_train(
        torch.from_numpy(x), _t(p), _t(s),
        mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-6)
    for k in ("mean", "var"):
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=0,
                                   atol=1e-6, err_msg=k)
        assert not ts[k].requires_grad


def _gpn_inputs(S=6, B=2, half=2, seed=0):
    rng = np.random.RandomState(seed)
    N, L = JCFG.obj_num, JCFG.gcn_dim
    x_obj = np.maximum(rng.randn(B, N, L), 0).astype("f")
    oi = np.full((S, 2, half, N), N - 1, np.int32)
    am = np.zeros((S, 2, half, N), np.float32)
    for idx in np.ndindex(S, 2, half):
        n = rng.randint(2, 9)
        oi[idx][:n] = rng.choice(N - 1, n, replace=False)
        am[idx][:n] = 1
    # a duplicated positive: equal scores, the first must win on both sides
    oi[0, 0, 1], am[0, 0, 1] = oi[0, 0, 0], am[0, 0, 0]
    return x_obj, oi, am, np.repeat(np.arange(B), S // B).astype(np.int32)


@pytest.mark.parametrize("gt", [False, True])
def test_gpn_train_forward_matches_jax(gt):
    jcfg = JCFG.replace(use_gt_subg=gt)
    jp, _, tp, _ = _models(jcfg)
    x, oi, am, ix = _gpn_inputs()
    j = JG.gpn_train_forward(_j(jp), jnp.asarray(x), jnp.asarray(oi),
                             jnp.asarray(am), jnp.asarray(ix), jcfg,
                             train=True, return_chosen=True)
    t = G.gpn_train_forward(tp, torch.from_numpy(x),
                            torch.from_numpy(oi).long(), torch.from_numpy(am),
                            torch.from_numpy(ix).long(), _port_cfg(jcfg),
                            train=True)
    if gt:
        assert j[0] is None and t[0] is None
    else:
        np.testing.assert_allclose(float(t[0]), float(j[0]), rtol=0,
                                   atol=1e-6)
    np.testing.assert_array_equal(t[5].numpy(), np.asarray(j[5]))
    for a, b in zip(t[1:5], j[1:5]):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=1e-6)


def test_bce_loss_both_forms_match_jax_with_finite_gradients():
    """The softplus form on logits and the score form agree with the JAX
    package's; the score form's gradient is finite at scores of exactly 0
    and 1 (and the interior keeps d/ds -log(s) = -1/s)."""
    scores = np.asarray([0.0, 1.0, 0.3, 1e-38, 0.999], np.float32)
    targets = np.asarray([1.0, 0.0, 1.0, 0.0, 1.0], np.float32)
    s = torch.from_numpy(scores).requires_grad_()
    loss = G.bce_loss(s, torch.from_numpy(targets))
    (g,) = torch.autograd.grad(loss, s)
    np.testing.assert_allclose(
        float(loss), float(JG.bce_loss(jnp.asarray(scores),
                                       jnp.asarray(targets))), rtol=1e-6)
    np.testing.assert_allclose(
        float(loss), torch.nn.BCELoss()(torch.from_numpy(scores),
                                        torch.from_numpy(targets)).item(),
        rtol=1e-6)
    assert torch.isfinite(g).all(), g
    np.testing.assert_allclose(g[2].item(), (-1.0 / 0.3) / 5, rtol=1e-5)
    logits = np.asarray([-120.0, 120.0, -0.8, 3.0, 0.0], np.float32)
    lt = torch.from_numpy(logits).requires_grad_()
    loss = G.bce_loss(torch.sigmoid(lt), torch.from_numpy(targets),
                      logits=lt)
    (g,) = torch.autograd.grad(loss, lt)
    j = JG.bce_loss(jax.nn.sigmoid(jnp.asarray(logits)), jnp.asarray(targets),
                    logits=jnp.asarray(logits))
    np.testing.assert_allclose(float(loss), float(j), rtol=1e-6)
    assert torch.isfinite(g).all(), g


def _feats(cfg, S, seed):
    """Random per-row features for forward_teacher, as numpy."""
    rng = np.random.RandomState(seed)
    R, H, N = cfg.rnn_size, cfg.att_hid_size, cfg.obj_num
    mask = (rng.rand(S, N) > 0.5).astype("f")
    mask[:, 0] = 1
    return dict(fc=rng.randn(S, R).astype("f"),
                att=rng.randn(S, N, R).astype("f"),
                p_att=rng.randn(S, N, H).astype("f"), mask=mask,
                fc_ih=(rng.randn(S, 4 * R) * 0.1).astype("f"))


def _labels(cfg, S, seed):
    rng = np.random.RandomState(seed)
    lab = np.zeros((S, cfg.seq_length + 2), np.int32)
    lab[:, 1:12] = rng.randint(1, cfg.vocab_size + 1, (S, 11))
    return lab


def _teacher(jp, tp, f, lab, ss_prob, jcfg=JCFG):
    j = JD.forward_teacher(_j(jp), JD.PreparedFeatures(
        **{k: jnp.asarray(v) for k, v in f.items()}), jnp.asarray(lab),
        jcfg, train=True, ss_prob=ss_prob)
    t = D.forward_teacher(tp, D.PreparedFeatures(**_t(f)),
                          torch.from_numpy(lab).long(), _port_cfg(jcfg),
                          train=True, ss_prob=ss_prob)
    return t, np.asarray(j)


@pytest.mark.parametrize("ss_prob", [None, 0.0])
def test_forward_teacher_matches_jax(ss_prob):
    """The hoisted path (ss_prob None) and the scheduled-sampling path at
    probability 0, whose logprobs also equal the hoisted path's."""
    jp, _, tp, _ = _models(JCFG, seed=2)
    f, lab = _feats(JCFG, 5, seed=3), _labels(JCFG, 5, seed=4)
    t, j = _teacher(jp, tp, f, lab, ss_prob)
    assert t.shape == (5, JCFG.seq_length + 1, JCFG.vocab_size + 1)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=0, atol=1e-5)
    if ss_prob is not None:
        hoisted = D.forward_teacher(tp, D.PreparedFeatures(**_t(f)),
                                    torch.from_numpy(lab).long(),
                                    _port_cfg(JCFG), train=True)
        np.testing.assert_allclose(t.detach().numpy(),
                                   hoisted.detach().numpy(), rtol=0,
                                   atol=1e-5)


def test_scheduled_sampling_at_one_feeds_the_dominant_token():
    """ss_prob 1 with the logit bias giving one token all the mass: both
    packages feed that token at every step i >= 1, so the logprobs equal
    the hoisted path's on labels holding that token from step 1."""
    k = 7
    jp, _, _, _ = _models(JCFG, seed=5)
    jp["decoder"]["logit"]["b"][k] = 1e4
    tp = params_from_numpy(jp, "cpu")
    f, lab = _feats(JCFG, 4, seed=6), _labels(JCFG, 4, seed=7)
    t, j = _teacher(jp, tp, f, lab, 1.0)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=0, atol=1e-5)
    fed = lab.copy()
    fed[:, 1:] = k
    hoisted = D.forward_teacher(tp, D.PreparedFeatures(**_t(f)),
                                torch.from_numpy(fed).long(),
                                _port_cfg(JCFG), train=True)
    np.testing.assert_allclose(t.detach().numpy(), hoisted.detach().numpy(),
                               rtol=0, atol=1e-5)


def test_dropout_rule():
    """Keep with probability 1 - p, scale the kept by 1 / (1 - p), one mask
    entry per element, drawn from the generator (same seed, same mask);
    off without a generator or outside training.  The sGPN's fixed 0.5
    dropout keeps half and doubles."""
    x = torch.rand(400, 250) + 0.5
    g = torch.Generator().manual_seed(3)
    y = D._dropout(x, 0.3, g, True)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    torch.testing.assert_close(y[kept], (x / 0.7)[kept], rtol=0, atol=0)
    assert kept.any(0).all() and (~kept).any(1).all()
    again = D._dropout(x, 0.3, torch.Generator().manual_seed(3), True)
    assert torch.equal(y, again)
    assert D._dropout(x, 0.3, None, True) is x
    assert D._dropout(x, 0.3, g, False) is x
    pick = torch.zeros(250, 1)
    pick[0] = 1.0               # the logit is the first hidden unit
    params = {"gpn": {"fc1": {"w": torch.eye(250), "b": torch.zeros(250)},
                      "fc2": {"w": pick, "b": torch.zeros(1)}}}
    s1, l1 = G.gpn_score(params, x, train=True,
                         generator=torch.Generator().manual_seed(4),
                         return_logits=True)
    kept = l1 != 0
    assert abs(kept.float().mean().item() - 0.5) < 0.1
    torch.testing.assert_close(l1[kept], 2 * x[kept, 0], rtol=0, atol=0)
    torch.testing.assert_close(s1, torch.sigmoid(l1))


def test_bf16_residuals_backward_matches_jax_custom_vjp():
    """The autograd Function's forward is _lstm_nonlin bit for bit; its
    backward equals the JAX package's custom_vjp on the same inputs (the
    same bfloat16 rounding of g, c, c2) to float32 rounding, and stays
    within tests/test_bf16_residuals.py's bound of plain autograd."""
    rng = np.random.RandomState(2)
    g, c = rng.randn(64, 64).astype("f"), rng.randn(64, 16).astype("f")
    dh, dc = rng.randn(64, 16).astype("f"), rng.randn(64, 16).astype("f")

    def jgrads(fn):
        def loss(g_, c_):
            h2, c2 = fn(g_, c_, jnp.float32, False)
            return (h2 * dh).sum() + (c2 * dc).sum()
        return jax.grad(loss, argnums=(0, 1))(jnp.asarray(g), jnp.asarray(c))

    gt, ct = (torch.from_numpy(a).requires_grad_() for a in (g, c))
    h_ref, c_ref = D._lstm_nonlin(gt, ct)
    h2, c2 = D._LSTMNonlinB16R.apply(gt, ct)
    assert torch.equal(h2, h_ref) and torch.equal(c2, c_ref)
    got = torch.autograd.grad((h2 * torch.from_numpy(dh)).sum()
                              + (c2 * torch.from_numpy(dc)).sum(), (gt, ct))
    plain = torch.autograd.grad((h_ref * torch.from_numpy(dh)).sum()
                                + (c_ref * torch.from_numpy(dc)).sum(),
                                (gt, ct))
    for a, b, p in zip(got, jgrads(JD._lstm_nonlin_b16r), plain):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
        rel = torch.linalg.norm(a - p) / torch.linalg.norm(p)
        assert 0 < rel < 0.02, rel


def _decode_inputs(cfg, B=2, S=6, seed=0):
    rng = np.random.RandomState(seed)
    graphs, subs = [], []
    for _ in range(B):
        n = 10
        graphs.append(make_scene_graph(
            rng.rand(n, cfg.att_feat_size).astype("f"),
            rng.rand(n, cfg.num_obj_classes).astype("f"),
            rng.randint(0, n, (12, 2)), rng.rand(12, cfg.num_rel_classes
                                                 ).astype("f")))
        subs.append(pad_subgraph_set(subgraphs_from_masks(
            (rng.rand(S, 36) > 0.8).astype("f"),
            (rng.rand(S, 64) > 0.8).astype("f")), 8))
    graph = SceneGraph(*(np.concatenate(x) for x in zip(*graphs)))
    subs = SubgraphSet(*(np.stack(x) for x in zip(*subs)))
    return to_device(graph, "cpu"), to_device(subs, "cpu")


@pytest.mark.parametrize("beam", [2, 1])
def test_inference_entry_points_run_without_autograd(beam):
    """Params that require grad (a trained model's leaves) decode to the
    same tokens as their detached copies, and no output has a grad_fn."""
    cfg = _port_cfg(JCFG)
    params, state = init_params(cfg, seed=1, device="cpu",
                                requires_grad=True)
    assert params["decoder"]["logit"]["w"].requires_grad
    assert not any(t.requires_grad for layer in state["gcn_bn"]
                   for u in layer for t in u.values())
    detached = jax.tree_util.tree_map(lambda t: t.detach(), params)
    graph, subs = _decode_inputs(cfg)
    ecfg = EvalConfig(beam_size=beam, gpn_max_subg=4)
    outs = []
    for p in (params, detached):
        enc = encode_images_batched(p, state, graph, subs, cfg, ecfg)
        assert enc.feats.fc.grad_fn is None and enc.scores.grad_fn is None
        out = beam_search(p, enc.feats, cfg, ecfg) if beam > 1 else \
            sample(p, enc.feats, cfg, ecfg)
        assert all(t.grad_fn is None for t in out if t is not None)
        outs.append(out)
    assert torch.equal(outs[0].seq, outs[1].seq)
    assert torch.equal(outs[0].logprobs, outs[1].logprobs)


def test_bf16_residuals_train_forward_bitwise_and_gradient_bound():
    """End to end through train_forward: the flag leaves the forward
    (every logprob) bitwise equal and moves the gradient by bfloat16
    residual rounding only (relative global-norm delta < 0.02, the bound
    of tests/test_bf16_residuals.py)."""
    from subgc_tpu_torch.data.synthetic import synthetic_train_batch
    from subgc_tpu_torch.models.subgc import train_forward
    from subgc_tpu_torch.train.optim import tree_leaves
    from subgc_tpu_torch.train.step import batch_to_device
    cfg = _port_cfg(JCFG)
    params_np, state_np = init_params_numpy(cfg, seed=3)
    b = batch_to_device(synthetic_train_batch(cfg, 2, seed=4), "cpu")
    out = []
    for flag in (False, True):
        p = params_from_numpy(params_np, "cpu", requires_grad=True)
        lp, gl, _, _ = train_forward(
            p, params_from_numpy(state_np, "cpu"), b.graph, b.labels,
            b.sub_obj_ind, b.sub_att_mask, b.img_ix,
            cfg.replace(bf16_residuals=flag), train=True)
        grads = torch.autograd.grad(lp.sum() + gl, tree_leaves(p),
                                    allow_unused=True)
        out.append((lp.detach(), [g for g in grads if g is not None]))
    assert torch.equal(out[0][0], out[1][0])
    num = sum(((a - b_) ** 2).sum() for a, b_ in zip(out[0][1], out[1][1]))
    den = sum((a ** 2).sum() for a in out[0][1])
    assert 0 < (num / den).sqrt() < 0.02
