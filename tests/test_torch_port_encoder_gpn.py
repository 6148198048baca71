"""The port's encoder, sGPN test path and sub-graph NMS held against the JAX
package: ``encode_graph`` and ``gpn_test_forward`` within atol 1e-5 (float32
summation order), NMS keep sets exactly equal in both forms."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subgc_tpu.config import ModelConfig as JModelConfig
from subgc_tpu.graph import SceneGraph as JSceneGraph
from subgc_tpu.models import encoder as JE
from subgc_tpu.models import gpn as JG
from subgc_tpu_torch.config import ModelConfig
from subgc_tpu_torch.graph import SceneGraph
from subgc_tpu_torch.models import encoder as E
from subgc_tpu_torch.models import gpn as G
from subgc_tpu_torch.models.params import params_from_numpy

ATOL = 1e-5


def _port_cfg(jcfg):
    return ModelConfig(**{f: getattr(jcfg, f)
                          for f in ModelConfig.__dataclass_fields__})


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _graph(cfg, B, seed):
    rng = np.random.RandomState(seed)
    N, K = cfg.obj_num, cfg.rel_num
    return (rng.rand(B, N, cfg.att_feat_size).astype("f"),
            rng.rand(B, N, cfg.num_obj_classes).astype("f"),
            rng.randint(0, N, (B, K, 2)).astype(np.int32),
            rng.rand(B, K, cfg.num_rel_classes).astype("f"))


def _subs(cfg, S, seed, pool=None):
    rng = np.random.RandomState(seed)
    N = cfg.obj_num
    oi = np.full((S, N), N - 1, np.int32)
    am = np.zeros((S, N), np.float32)
    for s in range(S):
        hi = pool or N - 1
        n = rng.randint(2, min(8, hi + 1))
        oi[s, :n] = rng.choice(hi, n, replace=False)
        am[s, :n] = 1
    return oi, am


def _encode_both(tiny_cfg, tiny_params, B=3, seed=0):
    arrays = _graph(tiny_cfg, B, seed)
    params, state = tiny_params
    jx, jp, _ = JE.encode_graph(params, state,
                                JSceneGraph(*map(jnp.asarray, arrays)),
                                tiny_cfg)
    tp = params_from_numpy(_np_tree(params), "cpu")
    g = SceneGraph(*(torch.from_numpy(a) for a in arrays))
    g = g._replace(rel_ind=g.rel_ind.long())
    px, pp, _ = E.encode_graph(tp, state, g, _port_cfg(tiny_cfg))
    return (np.asarray(jx), np.asarray(jp)), (px, pp), tp


def test_encode_graph_matches_jax(tiny_cfg, tiny_params):
    (jx, jp), (px, pp), _ = _encode_both(tiny_cfg, tiny_params)
    np.testing.assert_allclose(px.numpy(), jx, rtol=0, atol=ATOL)
    np.testing.assert_allclose(pp.numpy(), jp, rtol=0, atol=ATOL)


def test_one_hot_out_of_range_is_zero():
    oh = E.one_hot(torch.tensor([0, 2, 3, -1]), 3)
    ref = np.asarray(jax.nn.one_hot(jnp.asarray([0, 2, 3, -1]), 3))
    np.testing.assert_array_equal(oh.numpy(), ref)


def test_gpn_test_forward_matches_jax(tiny_cfg, tiny_params):
    (jx, _), (px, _), tp = _encode_both(tiny_cfg, tiny_params, B=2, seed=1)
    per_img = [_subs(tiny_cfg, 12, seed=10 + b) for b in range(2)]
    oi = np.stack([s[0] for s in per_img])
    am = np.stack([s[1] for s in per_img])
    # the port's batched call against the JAX package's per-image call
    out = G.gpn_test_forward(tp, px, torch.from_numpy(oi).long(),
                             torch.from_numpy(am), _port_cfg(tiny_cfg))
    for b in range(2):
        ref = JG.gpn_test_forward(tiny_params[0], jnp.asarray(jx[b]),
                                  jnp.asarray(oi[b]), jnp.asarray(am[b]),
                                  tiny_cfg)
        np.testing.assert_allclose(out.read_out[b].numpy(),
                                   np.asarray(ref.read_out), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(out.scores[b].numpy(),
                                   np.asarray(ref.scores), rtol=0, atol=ATOL)
        ro = G.readout_project(tp, out.read_out[b])
        np.testing.assert_allclose(
            ro.numpy(), np.asarray(JG.readout_project(tiny_params[0],
                                                      ref.read_out)),
            rtol=0, atol=ATOL)


def _nms_case(rng, cfg, S):
    oi, am = _subs(cfg, S, seed=int(rng.randint(1 << 30)),
                   pool=int(rng.randint(4, 12)))   # small pool: heavy overlap
    scores = rng.rand(S).astype(np.float32)
    valid = rng.rand(S) > 0.1
    valid[0] = True
    return scores, oi, am, valid


@pytest.mark.parametrize("parallel", [True, False])
def test_nms_keep_sets_match_jax(parallel):
    """Fuzz over seeds with tied scores, invalid rows and truncation; the
    port runs each trial's images as one batch."""
    cfg, jcfg = ModelConfig(), JModelConfig()
    rng = np.random.RandomState(0)
    for trial in range(12):
        S = int(rng.choice([8, 16, 64]))
        thres = float(rng.choice([0.2, 0.55, 0.75, 0.95]))
        max_keep = int(rng.choice([1, 3, 10, S]))
        cases = [_nms_case(rng, cfg, S) for _ in range(3)]
        if trial % 3 == 0:
            for c in cases:
                c[0][: S // 2] = c[0][0]                # tie block
        batch = [torch.from_numpy(np.stack([c[i] for c in cases]))
                 for i in range(4)]
        batch[1] = batch[1].long()
        ki, kv = G.subgraph_nms(*batch, cfg, thres, max_keep,
                                parallel=parallel)
        for b, c in enumerate(cases):
            jki, jkv = JG.subgraph_nms(*map(jnp.asarray, c), jcfg, thres,
                                       max_keep, parallel=parallel)
            np.testing.assert_array_equal(kv[b].numpy(), np.asarray(jkv),
                                          err_msg=f"trial {trial} valid")
            np.testing.assert_array_equal(ki[b].numpy(), np.asarray(jki),
                                          err_msg=f"trial {trial} keep")


def test_nms_single_image_suppression_chain():
    """A->B->C chain: A kills B, B (dead) cannot kill C."""
    cfg = ModelConfig()
    N = cfg.obj_num
    oi = np.full((3, N), N - 1, np.int64)
    am = np.zeros((3, N), np.float32)
    for i, nodes in enumerate([(0, 1), (1, 2), (2, 3)]):
        oi[i, :2] = nodes
        am[i, :2] = 1
    for par in (False, True):
        ki, kv = G.subgraph_nms(torch.tensor([0.9, 0.8, 0.7]),
                                torch.from_numpy(oi), torch.from_numpy(am),
                                torch.ones(3, dtype=torch.bool), cfg, 0.3, 3,
                                parallel=par)
        assert kv.tolist() == [True, True, False]
        assert ki.tolist()[:2] == [0, 2]
