"""The port's decoder and beam search held against the JAX package.

Feature preparation and one decode step within atol 1e-5 (float32,
summation order); the word-major top-k and beam tokens exactly; beam scores
within rtol 1e-5; and the pinned ``tests/golden_decode.json`` reproduced
from the weights and inputs of ``tests/test_golden.py``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subgc_tpu.config import EvalConfig as JEvalConfig
from subgc_tpu.decode import beam as JB
from subgc_tpu.models import decoder as JD
from subgc_tpu_torch.config import EvalConfig, ModelConfig
from subgc_tpu_torch.decode import beam as B
from subgc_tpu_torch.graph import SceneGraph, SubgraphSet
from subgc_tpu_torch.models import decoder as D
from subgc_tpu_torch.models import subgc
from subgc_tpu_torch.models.params import params_from_numpy

ATOL = 1e-5


def _port_cfg(jcfg):
    return ModelConfig(**{f: getattr(jcfg, f)
                          for f in ModelConfig.__dataclass_fields__})


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


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


def _both_feats(tiny_cfg, tiny_params, image_shared, seed=0):
    fc, x, oi, am = _node_inputs(tiny_cfg, seed=seed)
    jf = JD.prepare_features_nodes(tiny_params[0], jnp.asarray(fc),
                                   jnp.asarray(x), jnp.asarray(oi),
                                   jnp.asarray(am), tiny_cfg,
                                   image_shared=image_shared)
    tp = params_from_numpy(_np_tree(tiny_params[0]), "cpu")
    pf = D.prepare_features_nodes(tp, torch.from_numpy(fc),
                                  torch.from_numpy(x),
                                  torch.from_numpy(oi).long(),
                                  torch.from_numpy(am), _port_cfg(tiny_cfg),
                                  image_shared=image_shared)
    return jf, pf, tp


@pytest.mark.parametrize("image_shared", [True, False])
def test_prepare_features_nodes_matches_jax(tiny_cfg, tiny_params,
                                            image_shared):
    jf, pf, _ = _both_feats(tiny_cfg, tiny_params, image_shared)
    for name in D.PreparedFeatures._fields:
        j, p = getattr(jf, name), getattr(pf, name)
        assert (j is None) == (p is None), name
        if j is not None:
            np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=0,
                                       atol=ATOL, err_msg=name)


@pytest.mark.parametrize("image_shared", [True, False])
def test_decode_step_matches_jax(tiny_cfg, tiny_params, image_shared):
    """One beam-layout step (tokens [S, bdash]) against the JAX step under
    the beam search's per-sub-graph vmap."""
    jf, pf, tp = _both_feats(tiny_cfg, tiny_params, image_shared, seed=1)
    S, bdash, R = jf.fc.shape[0], 2, tiny_cfg.rnn_size
    rng = np.random.RandomState(2)
    st = [rng.uniform(-1, 1, (S, bdash, R)).astype("f") for _ in range(4)]
    tok = rng.randint(0, tiny_cfg.vocab_size + 1, (S, bdash))
    if image_shared:
        # one image: the streams gain their image axis, every row maps to 0
        jf = jf._replace(att_img=jf.att_img[None], p_att_img=jf.p_att_img[None],
                         img_ix=jnp.zeros((S,), jnp.int32))
        pf = pf._replace(att_img=pf.att_img[None], p_att_img=pf.p_att_img[None],
                         img_ix=torch.zeros((S,), dtype=torch.int64))
        axes = JD.PreparedFeatures(fc=0, att=None, p_att=None, mask=0,
                                   fc_ih=0, att_img=None, p_att_img=None,
                                   img_ix=0)
    else:
        axes = 0
    j_lp, j_st, _ = jax.vmap(
        lambda s, t, f: JD.decode_step(tiny_params[0], JD.DecoderState(*s),
                                       t, f, tiny_cfg),
        in_axes=(0, 0, axes))(tuple(map(jnp.asarray, st)),
                              jnp.asarray(tok, jnp.int32), jf)
    p_lp, p_st, _ = D.decode_step(
        tp, D.DecoderState(*map(torch.from_numpy, st)),
        torch.from_numpy(tok).long(), pf, _port_cfg(tiny_cfg))
    np.testing.assert_allclose(p_lp.numpy(), np.asarray(j_lp), rtol=0,
                               atol=ATOL)
    for p, j in zip(p_st, j_st):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=0,
                                   atol=ATOL)


def test_topk_wordmajor_ties_exact():
    """Engineered ties: equal values across words and beams resolve (lower
    word, then lower beam), and -inf rows behave as in the JAX pass."""
    rng = np.random.RandomState(0)
    for trial in range(20):
        bdash, V1 = int(rng.choice([2, 3, 4])), int(rng.choice([5, 9, 17]))
        cand = rng.choice([-3.0, -1.5, -1.0, -0.5],
                          (bdash, V1)).astype(np.float32)
        if trial % 4 == 0:
            cand[1:] = -np.inf
        if trial % 5 == 0:
            cand[:] = -np.inf
        jv, jq, jc = JB._topk_small_wordmajor(jnp.asarray(cand), bdash)
        pv, pq, pc = B._topk_small_wordmajor(torch.from_numpy(cand)[None],
                                             bdash)
        np.testing.assert_array_equal(pv[0].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(pq[0].numpy(), np.asarray(jq))
        np.testing.assert_array_equal(pc[0].numpy(), np.asarray(jc))


@pytest.mark.parametrize("image_shared,constraint",
                         [(True, 0), (False, 0), (True, 1)])
def test_beam_search_matches_jax(tiny_cfg, tiny_params, image_shared,
                                 constraint):
    jf, pf, tp = _both_feats(tiny_cfg, tiny_params, image_shared, seed=3)
    jcfg = JEvalConfig(beam_size=2, decoding_constraint=constraint)
    j = JB.beam_search(tiny_params[0], jf, tiny_cfg, jcfg)
    p = B.beam_search(tp, pf, _port_cfg(tiny_cfg),
                      EvalConfig(beam_size=2, decoding_constraint=constraint))
    np.testing.assert_array_equal(p.seq.numpy(), np.asarray(j.seq))
    np.testing.assert_array_equal(p.all_seqs.numpy(), np.asarray(j.all_seqs))
    np.testing.assert_allclose(p.all_ps.numpy(), np.asarray(j.all_ps),
                               rtol=1e-5)
    np.testing.assert_allclose(p.logprobs.numpy(), np.asarray(j.logprobs),
                               rtol=1e-5, atol=ATOL)


def test_port_reproduces_golden_decode():
    """tests/golden_decode.json from test_golden's weights and inputs."""
    from tests.test_golden import CFG, _inputs
    from subgc_tpu.models.params import init_params as j_init

    params, state = j_init(jax.random.PRNGKey(7), CFG, n_obj_names=15,
                           n_pred_names=8)
    tp = params_from_numpy(_np_tree(params), "cpu")
    graph, subs = _inputs()
    g = SceneGraph(*(torch.from_numpy(np.array(a)) for a in graph))
    g = g._replace(rel_ind=g.rel_ind.long())
    s = SubgraphSet(*(torch.from_numpy(np.array(a)) for a in subs))
    s = s._replace(obj_ind=s.obj_ind.long(), pred_ind=s.pred_ind.long())
    cfg = _port_cfg(CFG)
    ecfg = EvalConfig(beam_size=2, gpn_nms_thres=0.75, gpn_max_subg=4)
    enc = subgc.encode_image(tp, state, g, s, cfg, ecfg)
    out = B.beam_search(tp, enc.feats, cfg, ecfg)
    n = int(enc.keep_valid.sum())
    with open(os.path.join(os.path.dirname(__file__),
                           "golden_decode.json")) as f:
        pin = json.load(f)
    assert enc.keep_ind[:n].tolist() == pin["keep"]
    assert out.seq[:n].tolist() == pin["seqs"]
    np.testing.assert_allclose(enc.scores[:n].numpy(), pin["scores"],
                               rtol=1e-5)
