"""The port's BatchNorm paths held against the JAX package: the GCN's
BatchNorm (Full-GC), ``att_embed`` under ``use_bn`` 1/2 in every feature
layout, and Full_GC_Kar / Sub-GC ``use_bn=2`` beam search end to end.

Running statistics and affine parameters are drawn away from their initial
values (mean ~N(0, 0.05), var ~U(0.8, 1.2), as
``tests/test_fullgc_parity.py`` sets them), so the eval formula is
exercised.  Floats within atol 1e-5 (float32 summation order); beam tokens
exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subgc_tpu.config import EvalConfig as JEvalConfig
from subgc_tpu.config import ModelConfig as JModelConfig
from subgc_tpu.decode import beam as JB
from subgc_tpu.graph import SceneGraph as JSceneGraph
from subgc_tpu.graph import SubgraphSet as JSubgraphSet
from subgc_tpu.models import decoder as JD
from subgc_tpu.models import encoder as JE
from subgc_tpu.models import subgc as JS
from subgc_tpu.models.params import init_params as j_init_params
from subgc_tpu.train.checkpoint import save_pytree_npz
from subgc_tpu_torch.config import EvalConfig, ModelConfig
from subgc_tpu_torch.decode import beam as B
from subgc_tpu_torch.graph import SceneGraph, SubgraphSet
from subgc_tpu_torch.models import decoder as D
from subgc_tpu_torch.models import encoder as E
from subgc_tpu_torch.models import subgc as S
from subgc_tpu_torch.models.params import (init_params, init_params_numpy,
                                           load_model_npz, params_from_numpy)

ATOL = 1e-5
WIDTHS = dict(vocab_size=50, seq_length=16, rnn_size=64,
              input_encoding_size=48, att_hid_size=32, gcn_dim=40,
              fc_feat_size=64, att_feat_size=80, embed_dim=20,
              num_obj_classes=30, num_rel_classes=10)
# the Full_GC_Kar preset's model at tests/test_fullgc_parity.py's widths
FULL_GC = JModelConfig(**WIDTHS, noun_fuse=False, pred_emb_type=2,
                       gcn_layers=4, gcn_residual=1, gcn_bn=True,
                       use_gpn=False)


def _port_cfg(jcfg):
    return ModelConfig(**{f: getattr(jcfg, f)
                          for f in ModelConfig.__dataclass_fields__})


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _perturb_bn(params, state, seed):
    """numpy (params, state) with every BatchNorm's running stats and
    affine parameters drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    params, state = _np_tree(params), _np_tree(state)

    def stats(s):
        return {"mean": rng.normal(0, 0.05, s["mean"].shape).astype("f"),
                "var": rng.uniform(0.8, 1.2, s["var"].shape).astype("f")}

    def affine(p):
        return {"scale": rng.uniform(0.8, 1.2, p["scale"].shape).astype("f"),
                "bias": rng.normal(0, 0.05, p["bias"].shape).astype("f")}

    state["gcn_bn"] = [[stats(u) if u else u for u in layer]
                       for layer in state["gcn_bn"]]
    for layer in params["gcn"]:
        for u in layer:
            if "bn" in u:
                u["bn"] = affine(u["bn"])
    if "att_bn" in state:
        state["att_bn"] = {k: stats(v) for k, v in state["att_bn"].items()}
        dec = params["decoder"]
        for k in ("att_bn0", "att_bn1"):
            if k in dec:
                dec[k] = affine(dec[k])
    return params, state


def _both_models(jcfg, seed=0):
    """(JAX params, JAX state, port params, port state) with perturbed
    BatchNorm, the port's on the CPU."""
    params, state = j_init_params(jax.random.PRNGKey(seed), jcfg,
                                  n_obj_names=30, n_pred_names=10)
    params, state = _perturb_bn(params, state, seed + 100)
    jp, js = (jax.tree_util.tree_map(jnp.asarray, t) for t in (params, state))
    return jp, js, params_from_numpy(params, "cpu"), \
        params_from_numpy(state, "cpu")


def _graph_arrays(cfg, B, seed):
    rng = np.random.RandomState(seed)
    N, K = cfg.obj_num, cfg.rel_num
    return (rng.rand(B, N, cfg.att_feat_size).astype("f"),
            rng.rand(B, N, cfg.num_obj_classes).astype("f"),
            rng.randint(0, N - 1, (B, K, 2)).astype(np.int32),
            rng.rand(B, K, cfg.num_rel_classes).astype("f"))


def _graphs(arrays):
    g = SceneGraph(*(torch.from_numpy(a) for a in arrays))
    return JSceneGraph(*map(jnp.asarray, arrays)), \
        g._replace(rel_ind=g.rel_ind.long())


def _tree_shapes(tree):
    if isinstance(tree, dict):
        return {k: _tree_shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_shapes(v) for v in tree]
    return tuple(np.shape(tree))


@pytest.mark.parametrize("kw", [dict(gcn_bn=True, use_gpn=False,
                                     noun_fuse=False, pred_emb_type=2,
                                     gcn_layers=4, gcn_residual=1),
                                dict(use_bn=1), dict(use_bn=2),
                                dict(use_gt_subg=True)])
def test_init_params_layout_matches_jax(kw):
    """Same keys and shapes as the JAX package's init_params, BatchNorm
    parameters and state at the same initial values, and the port's
    init_params carries the state as tensors."""
    jcfg = JModelConfig(**WIDTHS, **kw)
    jp, js = _np_tree(j_init_params(jax.random.PRNGKey(0), jcfg,
                                    n_obj_names=30, n_pred_names=10))
    pp, ps = init_params_numpy(_port_cfg(jcfg), seed=0, n_obj_names=30,
                               n_pred_names=10)
    assert _tree_shapes(pp) == _tree_shapes(jp)
    assert _tree_shapes(ps) == _tree_shapes(js)
    for a, b in zip(jax.tree_util.tree_leaves(ps),
                    jax.tree_util.tree_leaves(js)):
        np.testing.assert_array_equal(a, b)
    bn = [(k, v) for k, v in jax.tree_util.tree_leaves_with_path(jp)
          if any(getattr(p, "key", None) in ("bn", "att_bn0", "att_bn1")
                 for p in k)]
    assert bool(bn) == bool(jcfg.gcn_bn or jcfg.use_bn)
    for path, v in bn:
        got = pp
        for p in path:
            got = got[getattr(p, "key", getattr(p, "idx", None))]
        np.testing.assert_array_equal(got, v)
    _, tstate = init_params(_port_cfg(jcfg), device="cpu", n_obj_names=30,
                            n_pred_names=10)
    assert all(isinstance(x, torch.Tensor)
               for x in jax.tree_util.tree_leaves(tstate))


def test_batch_norm_1d_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(50, 40).astype("f") * 3
    p = {"scale": rng.uniform(0.5, 1.5, 40).astype("f"),
         "bias": rng.randn(40).astype("f")}
    s = {"mean": rng.normal(0, 0.5, 40).astype("f"),
         "var": rng.uniform(0.2, 2.0, 40).astype("f")}
    j, _ = JE.batch_norm_1d(jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, p), jax.tree_util.tree_map(jnp.asarray, s), train=False)
    t = E.batch_norm_1d(torch.from_numpy(x),
                        {k: torch.from_numpy(v) for k, v in p.items()},
                        {k: torch.from_numpy(v) for k, v in s.items()})
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)


def test_gcn_forward_bn_matches_jax():
    """Four BatchNorm'd GCN layers with residual 1, three images."""
    jp, js, tp, ts = _both_models(FULL_GC, seed=1)
    jg, tg = _graphs(_graph_arrays(FULL_GC, 3, seed=2))
    jx, jpred, jstate = JE.encode_graph(jp, js, jg, FULL_GC)
    px, ppred, _ = E.encode_graph(tp, ts, tg, _port_cfg(FULL_GC))
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ppred.numpy(), np.asarray(jpred), rtol=0,
                               atol=ATOL)


def _node_inputs(cfg, K=5, seed=0):
    rng = np.random.RandomState(seed)
    N, L = cfg.obj_num, cfg.gcn_dim
    oi = np.full((K, N), N - 1, np.int32)
    am = np.zeros((K, N), np.float32)
    for k in range(K):
        n = rng.randint(2, 9)
        oi[k, :n] = rng.choice(N - 1, n, replace=False)
        am[k, :n] = 1
    return (rng.randn(K, 2 * L).astype("f"),
            np.maximum(rng.randn(N, L), 0).astype("f"), oi, am)


def _features(fn, cfg, params, bn_state, fc, x, oi, am, xp):
    """One feature function of either package; ``xp`` converts inputs."""
    mod = JD if xp is jnp.asarray else D
    ind = xp(oi) if xp is jnp.asarray else torch.from_numpy(oi).long()
    if fn == "att_embed":
        att = mod.att_embed(params, xp(x[oi]), xp(am), cfg,
                            bn_state=bn_state)
        return {"att": att[0]}
    if fn == "prepare_features":
        prep = JD.prepare_features if mod is JD else D.prepare_features_bn
        f = prep(params, xp(fc), xp(x[oi]), xp(am), cfg, bn_state=bn_state)
        f = f if mod is JD else f[0]
    else:
        f = mod.prepare_features_nodes(
            params, xp(fc), xp(x), ind, xp(am), cfg, bn_state=bn_state,
            image_shared=fn == "nodes_image_shared")
    return {k: v for k, v in f._asdict().items() if v is not None}


@pytest.mark.parametrize("fn", ["att_embed", "prepare_features",
                                "nodes_per_row", "nodes_image_shared"])
@pytest.mark.parametrize("use_bn", [0, 1, 2])
def test_att_features_match_jax(fn, use_bn):
    """att_embed and the feature preparations in both layouts; per row
    under use_bn, padded slots are zero and their p_att is ctx2att's
    bias."""
    jcfg = JModelConfig(**WIDTHS, use_bn=use_bn)
    jp, js, tp, ts = _both_models(jcfg, seed=use_bn)
    args = _node_inputs(jcfg, seed=10 + use_bn)
    j = _features(fn, jcfg, jp, js.get("att_bn"), *args, jnp.asarray)
    p = _features(fn, _port_cfg(jcfg), tp, ts.get("att_bn"), *args,
                  torch.from_numpy)
    assert sorted(j) == sorted(p)
    for k in j:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(j[k]), rtol=0,
                                   atol=ATOL, err_msg=k)
    if use_bn and fn in ("nodes_per_row", "prepare_features"):
        pad = args[3] == 0
        assert (p["att"].numpy()[pad] == 0).all()
        np.testing.assert_array_equal(
            p["p_att"].numpy()[pad],
            np.broadcast_to(tp["decoder"]["ctx2att"]["b"].numpy(),
                            p["p_att"].numpy()[pad].shape))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fullgc_beam_tokens_match_jax(seed):
    """Full_GC_Kar end to end (encode_image + beam search at beam 3, one
    row per image over every non-dummy node): tokens exactly equal."""
    jp, js, tp, ts = _both_models(FULL_GC, seed=seed)
    jg, tg = _graphs(_graph_arrays(FULL_GC, 1, seed=20 + seed))
    cfg = _port_cfg(FULL_GC)
    jenc = JS.encode_image(jp, js, jg, None, FULL_GC,
                           JEvalConfig(beam_size=3))
    enc = S.encode_image(tp, ts, tg, None, cfg, EvalConfig(beam_size=3))
    for name in ("fc", "att", "p_att", "mask", "fc_ih"):
        np.testing.assert_allclose(
            getattr(enc.feats, name).numpy(),
            np.asarray(getattr(jenc.feats, name)), rtol=0, atol=ATOL,
            err_msg=name)
    assert enc.feats.att.shape[:2] == (1, FULL_GC.obj_num)
    assert enc.feats.mask.numpy().tolist() == \
        [[1.0] * (FULL_GC.obj_num - 1) + [0.0]]
    for a, b in ((enc.scores, jenc.scores), (enc.keep_ind, jenc.keep_ind),
                 (enc.keep_valid, jenc.keep_valid)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    j = JB.beam_search(jp, jenc.feats, FULL_GC, JEvalConfig(beam_size=3))
    p = B.beam_search(tp, enc.feats, cfg, EvalConfig(beam_size=3))
    np.testing.assert_array_equal(p.seq.numpy(), np.asarray(j.seq))
    np.testing.assert_array_equal(p.all_seqs.numpy(), np.asarray(j.all_seqs))
    np.testing.assert_allclose(p.logprobs.numpy(), np.asarray(j.logprobs),
                               rtol=0, atol=ATOL)


def _subs(cfg, S_, bucket, seed):
    rng = np.random.RandomState(seed)
    N = cfg.obj_num
    oi = np.full((bucket, N), N - 1, np.int32)
    am = np.zeros((bucket, N), np.float32)
    am[:, 0] = 1.0
    for s in range(S_):
        n = rng.randint(2, 8)
        am[s] = 0.0
        oi[s, :n] = rng.choice(N - 1, n, replace=False)
        am[s, :n] = 1
    return (oi, np.full((bucket, cfg.rel_num), cfg.rel_num - 1, np.int32),
            am, np.arange(bucket) < S_)


@pytest.mark.parametrize("image_shared", [True, False])
def test_subgc_use_bn2_beam_tokens_match_jax(image_shared):
    """Sub-GC with use_bn=2 through encode_image + beam search, both beam
    layouts: keep sets and tokens exactly equal."""
    jcfg = JModelConfig(**WIDTHS, use_bn=2, share_att_images=image_shared)
    jp, js, tp, ts = _both_models(jcfg, seed=5)
    jg, tg = _graphs(_graph_arrays(jcfg, 1, seed=30))
    subs = _subs(jcfg, 10, 16, seed=31)
    jecfg = JEvalConfig(beam_size=2, gpn_nms_thres=0.75, gpn_max_subg=6)
    ecfg = EvalConfig(beam_size=2, gpn_nms_thres=0.75, gpn_max_subg=6)
    jenc = JS.encode_image(jp, js, jg, JSubgraphSet(*map(jnp.asarray, subs)),
                           jcfg, jecfg)
    tsubs = SubgraphSet(*(torch.from_numpy(a) for a in subs))
    tsubs = tsubs._replace(obj_ind=tsubs.obj_ind.long())
    enc = S.encode_image(tp, ts, tg, tsubs, _port_cfg(jcfg), ecfg)
    np.testing.assert_array_equal(enc.keep_ind.numpy(),
                                  np.asarray(jenc.keep_ind))
    np.testing.assert_array_equal(enc.keep_valid.numpy(),
                                  np.asarray(jenc.keep_valid))
    j = JB.beam_search(jp, jenc.feats, jcfg, jecfg)
    p = B.beam_search(tp, enc.feats, _port_cfg(jcfg), ecfg)
    np.testing.assert_array_equal(p.seq.numpy(), np.asarray(j.seq))
    np.testing.assert_allclose(p.logprobs.numpy(), np.asarray(j.logprobs),
                               rtol=0, atol=ATOL)


def test_jax_checkpoint_state_loads(tmp_path):
    """A JAX model.npz with BatchNorm state ({"params", "state"}) loads
    through load_model_npz + params_from_numpy and encodes as the JAX
    package does."""
    params, state = _perturb_bn(*j_init_params(
        jax.random.PRNGKey(3), FULL_GC, n_obj_names=30, n_pred_names=10), 7)
    path = str(tmp_path / "model.npz")
    save_pytree_npz(path, {"params": params, "state": state})
    blob = load_model_npz(path)
    tp, ts = (params_from_numpy(blob[k], "cpu") for k in ("params", "state"))
    assert ts["gcn_bn"][3][2]["var"].dtype == torch.float32
    jg, tg = _graphs(_graph_arrays(FULL_GC, 1, seed=4))
    jx, _, _ = JE.encode_graph(jax.tree_util.tree_map(jnp.asarray, params),
                               jax.tree_util.tree_map(jnp.asarray, state),
                               jg, FULL_GC)
    px, _, _ = E.encode_graph(tp, ts, tg, _port_cfg(FULL_GC))
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=0, atol=ATOL)
