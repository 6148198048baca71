"""The port's bfloat16 chain (``compute_dtype="bfloat16"``, with and without
``bf16_lstm_gates``) held against the JAX package module by module, against
the JAX functions called eagerly in bf16 (the slice through both packages'
``run_test_split`` is ``tests/test_torch_port_bf16_slice.py``).  Inputs from
numpy seeds, the same weights through ``params_from_numpy``, at the test
widths.

Tolerances, each with its reason:

* GCN: rtol / atol 1e-2 of a bf16 product that may round one ulp (2^-8)
  apart, the two CPU libraries summing in other orders; with the GCN's
  weights scaled up so that the bf16 chain moves the output (checked);
* feature preparation and the LSTM cell: within one bf16 ulp (rtol 8e-3)
  for bf16 outputs, atol 1e-5 for float32 ones (measured: equal);
* ``decode_step``: the training route (``attention_teacher``, the XLA
  numerics) logprobs atol 1e-4; the inference route through the kernels'
  plain versions atol 5e-3 and weights 1e-3, since the kernels round where
  the Pallas kernels do (``ops/attention.py``), not where XLA does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subgc_tpu.models import decoder as JD
from subgc_tpu.models import encoder as JE
import subgc_tpu_torch as P
from subgc_tpu_torch.models import decoder as D
from subgc_tpu_torch.models import encoder as E
from subgc_tpu_torch.models.params import init_params_numpy, params_from_numpy

from .test_torch_port_train import one_thread  # noqa: F401

BF = torch.bfloat16
ULP = 8e-3            # one bf16 ulp, relative (2^-8 = 3.9e-3), with margin


def _cfgs(tiny_cfg, gates=False):
    """(JAX config, port config) in bf16, ``bf16_lstm_gates`` as asked."""
    jcfg = tiny_cfg.replace(compute_dtype="bfloat16", bf16_lstm_gates=gates)
    return jcfg, P.ModelConfig(**{f: getattr(jcfg, f)
                                  for f in P.ModelConfig.__dataclass_fields__})


def _tree_j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x).astype(jnp.float32))


def _params(cfg, gcn_scale=1.0):
    params, state = init_params_numpy(cfg, seed=3, n_obj_names=30,
                                      n_pred_names=10)
    rng = np.random.RandomState(1)
    for layer in params["gcn"]:
        for u in layer:
            for k in ("lft", "rgt"):
                u[k]["w"] = u[k]["w"] * gcn_scale
                u[k]["b"] = rng.uniform(-0.1, 0.1,
                                        u[k]["b"].shape).astype("f")
    return params, state


def _graph(cfg, seed=0, B=2):
    rng = np.random.RandomState(seed)
    N, K, L = cfg.obj_num, cfg.rel_num, cfg.gcn_dim
    return (rng.rand(B, N, L).astype("f"), rng.rand(B, K, L).astype("f"),
            rng.randint(0, N - 1, (B, K, 2)))


def test_gcn_forward_bf16_matches_jax(tiny_cfg):
    """GCN units in bf16 (bias in bf16), BatchNorm and the degree division
    in float32.  The GCN's weights are scaled by 300 so that its output is
    not dominated by the residual: the bf16 chain must move it away from
    the float32 one."""
    jcfg, cfg = _cfgs(tiny_cfg)
    params, state = _params(cfg, gcn_scale=300.0)
    x_obj, x_pred, rel = _graph(cfg)
    jo, jpr, _ = JE.gcn_forward(_tree_j(params), _tree_j(state),
                                jnp.asarray(x_obj), jnp.asarray(x_pred),
                                jnp.asarray(rel), jcfg)
    tp, ts = params_from_numpy(params, "cpu"), params_from_numpy(state, "cpu")
    args = (torch.from_numpy(x_obj), torch.from_numpy(x_pred),
            torch.from_numpy(rel))
    to, tpr, _ = E.gcn_forward(tp, ts, *args, cfg)
    o32, _, _ = E.gcn_forward(tp, ts, *args,
                              cfg.replace(compute_dtype="float32"))
    assert to.dtype == tpr.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-2,
                               atol=1e-2)
    np.testing.assert_allclose(tpr.numpy(), np.asarray(jpr), rtol=1e-2,
                               atol=1e-2)
    assert (to - o32).abs().max() > 0.1


@pytest.mark.parametrize("gates", [False, True])
@pytest.mark.parametrize("image_shared", [False, True])
def test_prepare_features_nodes_bf16_matches_jax(tiny_cfg, gates,
                                                 image_shared):
    """Streams stored in bf16 after their float32-biased projection;
    ``fc_ih`` in bf16 under bf16 gates, float32 otherwise."""
    jcfg, cfg = _cfgs(tiny_cfg, gates)
    params, _ = _params(cfg)
    rng = np.random.RandomState(2)
    x_obj = rng.rand(cfg.obj_num, cfg.gcn_dim).astype("f")
    fc = rng.rand(5, 2 * cfg.gcn_dim).astype("f")
    ind = rng.randint(0, cfg.obj_num - 1, (5, 6))
    mask = (rng.rand(5, 6) > 0.3).astype("f")
    mask[:, 0] = 1.0
    jf = JD.prepare_features_nodes(
        _tree_j(params), *map(jnp.asarray, (fc, x_obj, ind, mask)), jcfg,
        image_shared=image_shared)
    tf = D.prepare_features_nodes(
        params_from_numpy(params, "cpu"),
        *map(torch.from_numpy, (fc, x_obj, ind, mask)), cfg,
        image_shared=image_shared)
    want_bf16 = {"att", "p_att", "att_img", "p_att_img"} | (
        {"fc_ih"} if gates else set())
    for name in jf._fields:
        j, t = getattr(jf, name), getattr(tf, name)
        if j is None:
            assert t is None, name
            continue
        assert (t.dtype == BF) == (name in want_bf16), name
        assert (j.dtype == jnp.bfloat16) == (name in want_bf16), name
        np.testing.assert_allclose(_f32(t), _f32(j), rtol=ULP, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("gates", [False, True])
def test_lstm_cell_bf16_matches_jax(tiny_cfg, gates):
    """The LSTM cell, its gates through torch's products and then its
    nonlinearity, against JAX's ``_lstm_cell_gx``.  ``h`` rides in bf16,
    ``c`` in float32; under bf16 gates the gate streams, ``b_hh`` and the
    sigmoid / tanh are bf16 (the sigmoid as JAX lowers it, ``1 / (1 +
    exp(-x))`` op by op)."""
    jcfg, cfg = _cfgs(tiny_cfg, gates)
    params, _ = _params(cfg)
    R = cfg.rnn_size
    rng = np.random.RandomState(3)
    gx = rng.randn(4, 4 * R).astype("f")
    h = rng.uniform(-1, 1, (4, R)).astype("f")
    c = rng.randn(4, R).astype("f")
    jp = JD.cast_decoder_weights(_tree_j(params), jcfg)["decoder"]["att_lstm"]
    tp = D.cast_decoder_weights(params_from_numpy(params, "cpu"),
                                cfg)["decoder"]["att_lstm"]
    jgx, tgx = jnp.asarray(gx), torch.from_numpy(gx)
    if gates:
        jgx, tgx = jgx.astype(jnp.bfloat16), tgx.to(BF)
    jh, jc = JD._lstm_cell_gx(jp, jgx, jnp.asarray(h).astype(jnp.bfloat16),
                              jnp.asarray(c), jnp.bfloat16, gates)
    tg = D._lstm_gates(D._product("kernels", BF, gates), tp, tgx,
                       torch.from_numpy(h).to(BF), BF, gates)
    th, tc = D._lstm_nonlin(tg, torch.from_numpy(c), BF, gates)
    assert th.dtype == BF and tc.dtype == torch.float32
    np.testing.assert_allclose(_f32(th), _f32(jh), rtol=ULP, atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("gates", [False, True])
@pytest.mark.parametrize("layout", ["fanout", "per_row"])
@pytest.mark.parametrize("route", ["inference", "train"])
def test_decode_step_bf16_matches_jax(tiny_cfg, gates, layout, route):
    """Three steps of ``decode_step`` from the same state and tokens, both
    per-row layouts (the image-shared fan-out and the per-row streams of
    attention capture).  ``train`` (dropout off) attends through
    ``attention_teacher``, the XLA numerics; ``inference`` through the
    kernels' plain versions."""
    jcfg, cfg = _cfgs(tiny_cfg, gates)
    params, _ = _params(cfg)
    rng = np.random.RandomState(4)
    L, S = cfg.gcn_dim, 6
    x_obj = rng.rand(cfg.obj_num, L).astype("f")
    fc = rng.rand(S, 2 * L).astype("f")
    ind = rng.randint(0, cfg.obj_num - 1, (S, 6))
    mask = (rng.rand(S, 6) > 0.3).astype("f")
    mask[:, 0] = 1.0
    shared = layout == "fanout"
    jp = JD.cast_decoder_weights(_tree_j(params), jcfg)
    tp = D.cast_decoder_weights(params_from_numpy(params, "cpu"), cfg)
    jf = JD.prepare_features_nodes(
        jp, *map(jnp.asarray, (fc, x_obj, ind, mask)), jcfg,
        image_shared=shared)
    tf = D.prepare_features_nodes(
        tp, *map(torch.from_numpy, (fc, x_obj, ind, mask)), cfg,
        image_shared=shared)
    train = route == "train"
    js, ts = JD.init_state(S, jcfg), D.init_state(S, cfg, "cpu")
    tok = rng.randint(1, cfg.vocab_size, S)
    for _ in range(3):
        jlp, js, jw = JD.decode_step(jp, js, jnp.asarray(tok), jf, jcfg,
                                     train=train)
        tlp, ts, tw = D.decode_step(tp, ts, torch.from_numpy(tok), tf, cfg,
                                    train=train)
        tok = np.asarray(jlp).argmax(-1)
    assert [t.dtype for t in ts] == [BF, torch.float32] * 2
    assert tlp.dtype == tw.dtype == torch.float32
    tol = 1e-4 if train else 5e-3
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=1e-4 if train else 1e-3)
