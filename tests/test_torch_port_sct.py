"""The port's controllability (SCT) path held against the JAX package: the
host-side region-set matching and sub-graph construction, ``SCTLoader`` in
both branches (greedy and GT look-up), and ``run_test_split`` for
Sub_GC_Flickr_CTL and Sub_GC_Sup_Flickr_CTL (no NMS, captions in region-set
order): captions, sub-graph orders and scores equal.  Also the Sup.
model's all-ones scores, the NMS order on tied scores, the SCT artifact's
name and the runner's refusal of Full-GC.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import subgc_tpu.config as JC
from subgc_tpu.data import sct as JSCT
from subgc_tpu.data.dataset import EvalLoader as JEvalLoader
from subgc_tpu.data.synthetic import generate_dataset
from subgc_tpu.eval.runner import run_test_split as j_run_test_split
from subgc_tpu.models import gpn as JG
from subgc_tpu.models.params import init_params as j_init_params
import subgc_tpu_torch as P
from subgc_tpu_torch.data import sct as PSCT
from subgc_tpu_torch.models import gpn as G

WIDTHS = dict(rnn_size=48, input_encoding_size=32, att_hid_size=24,
              gcn_dim=32, fc_feat_size=48, att_feat_size=64, embed_dim=16,
              num_obj_classes=30, num_rel_classes=10)
PRESETS = {"greedy": "Sub_GC_Flickr_CTL", "gt": "Sub_GC_Sup_Flickr_CTL"}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_sct")
    return generate_dataset(str(root), n_images=15, vocab_size=40,
                            feat_dim=64, n_subgraphs=6, seed=61)


def _paths(man):
    return dict(input_json=man["input_json"],
                input_label_h5=man["input_label_h5"],
                sg_dir=man["sg_dir"], mask_dir=man["mask_dir"])


def _region_sets(man, branch):
    """{str(img_id): [G, R, 5]} and {img_id: (w, h)} for the test images.
    Greedy: 2-4 sets of 1-2 detector boxes, some jittered off their box
    (the adaptive threshold); GT: one set per GT sub-graph's seed boxes,
    so the exact seed-node look-up succeeds (tests/test_gt_subg.py)."""
    base = JEvalLoader(JC.ModelConfig(**WIDTHS, vocab_size=40),
                       JC.DataConfig(**_paths(man)), bucket=8)
    rng = np.random.RandomState(5)
    sct_dict, img_wh = {}, {}
    for ix in base.split_ix["test"]:
        img_id = base.ds.images[ix]["id"]
        boxes = np.asarray(base.sg.get(img_id)["boxes"])
        img_wh[img_id] = (592, 592)
        if branch == "gt":
            mask_list = base.masks.get(img_id)["subgraph_mask_list"]
            groups = [boxes[np.unique(np.asarray(mask_list[g][4]))]
                      for g in range(3)]
        else:
            groups = []
            for _ in range(rng.randint(2, 5)):
                pick = boxes[rng.choice(boxes.shape[0], rng.randint(1, 3),
                                        replace=False)]
                groups.append(pick + rng.choice([0, 0, 60]) *
                              rng.rand(*pick.shape))
        width = max(len(g) for g in groups)
        arr = np.zeros((len(groups), width, 5))
        for g_i, g in enumerate(groups):
            arr[g_i, :len(g), :4] = g
            arr[g_i, :len(g), 4] = 1
        sct_dict[str(img_id)] = arr
    return sct_dict, img_wh


def _cfgs(branch):
    over = dict(model=dict(WIDTHS, vocab_size=40))
    return (JC.build_configs(PRESETS[branch], **over),
            P.build_configs(PRESETS[branch], **over))


@pytest.mark.parametrize("fn", ["box_iou_single", "match_region_sets",
                                "greedy_subgraph"])
def test_sct_host_functions_match_jax(fn):
    rng = np.random.RandomState(0)
    for trial in range(20):
        n = rng.randint(3, 37)
        boxes = rng.rand(n, 4) * 300
        boxes[:, 2:] += boxes[:, :2]
        if fn == "box_iou_single":
            a, b = boxes[0], boxes[rng.randint(n)] + rng.randn(4) * 30
            assert PSCT.box_iou_single(a, b) == JSCT.box_iou_single(a, b)
        elif fn == "match_region_sets":
            sets = np.zeros((3, 4, 5))
            for g in range(3):
                k = rng.randint(1, 5)
                sets[g, :k, :4] = boxes[rng.randint(n, size=k)] \
                    + rng.randn(k, 4) * rng.choice([0, 20, 400])
                sets[g, :k, 4] = 1
            for a, b in zip(PSCT.match_region_sets(sets, boxes),
                            JSCT.match_region_sets(sets, boxes)):
                np.testing.assert_array_equal(a, b, err_msg=f"trial {trial}")
        else:
            cls = rng.randint(0, 6, n)
            rel = rng.randint(0, n, (rng.randint(1, 20), 2))
            seeds = rng.choice(n, rng.randint(1, 4), replace=False)
            for a, b in zip(PSCT.greedy_subgraph(seeds, cls, rel),
                            JSCT.greedy_subgraph(seeds, cls, rel)):
                np.testing.assert_array_equal(a, b, err_msg=f"trial {trial}")


@pytest.mark.parametrize("branch", ["greedy", "gt"])
def test_sct_loader_example_matches_jax(synth, branch):
    (jcfg, _, _), (cfg, _, _) = _cfgs(branch)
    sct_dict, img_wh = _region_sets(synth, branch)
    kw = dict(use_greedy_subg=branch == "greedy",
              use_gt_subg=branch == "gt", bucket=8)
    jl = JSCT.SCTLoader(jcfg, JC.DataConfig(**_paths(synth)), sct_dict,
                        img_wh, **kw)
    pl = P.SCTLoader(cfg, P.DataConfig(**_paths(synth)), sct_dict, img_wh,
                     **kw)
    assert len(pl) == len(jl) == 3
    for pos in range(len(pl)):
        j, p = jl.example(pos), pl.example(pos)
        assert p.n_subgraphs == j.n_subgraphs == len(sct_dict[str(p.info.id)])
        assert p.info == j.info
        for a, b in zip(p.graph + p.subs, j.graph + j.subs):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("branch", ["greedy", "gt"])
def test_sct_run_test_split_matches_jax(synth, branch):
    """No NMS, every region set decodes, captions in region-set order."""
    (jcfg, jecfg, _), (cfg, ecfg, _) = _cfgs(branch)
    assert ecfg.sct and ecfg.beam_size == 2
    sct_dict, img_wh = _region_sets(synth, branch)
    kw = dict(use_greedy_subg=ecfg.use_greedy_subg,
              use_gt_subg=ecfg.use_gt_subg, bucket=8)
    jl = JSCT.SCTLoader(jcfg, JC.DataConfig(**_paths(synth)), sct_dict,
                        img_wh, **kw)
    pl = P.SCTLoader(cfg, P.DataConfig(**_paths(synth)), sct_dict, img_wh,
                     **kw)
    params, state = j_init_params(jax.random.PRNGKey(2), jcfg,
                                  n_obj_names=30, n_pred_names=10)
    assert ("fc1" in params["gpn"]) == (branch == "greedy")
    jpreds, _, jn = j_run_test_split(params, state, jl, jcfg, jecfg,
                                     jl.vocab, verbose=False, batch_images=2)
    tp, ts = (P.params_from_numpy(jax.tree_util.tree_map(np.array, t), "cpu")
              for t in (params, state))
    preds, _, n = P.run_test_split(tp, ts, pl, cfg, ecfg, pl.vocab,
                                   verbose=False, batch_images=2,
                                   device="cpu")
    assert n == jn == sum(len(v) for v in sct_dict.values())
    for p, j in zip(preds, jpreds):
        n_sets = len(sct_dict[str(p["image_id"])])
        assert p["image_id"] == j["image_id"]
        assert p["caption"] == j["caption"]
        np.testing.assert_array_equal(p["sorted_subgraph_ind"],
                                      np.arange(n_sets))
        np.testing.assert_array_equal(p["sorted_subgraph_ind"],
                                      j["sorted_subgraph_ind"])
        np.testing.assert_allclose(p["subgraph_score"], j["subgraph_score"],
                                   rtol=0, atol=1e-5)
        if branch == "gt":
            assert (p["subgraph_score"] == 1.0).all()


def test_gt_subg_scores_are_ones():
    cfg = P.ModelConfig(**WIDTHS, use_gt_subg=True)
    params, _ = P.init_params(cfg, device="cpu")
    assert set(params["gpn"]) == {"readout1", "readout2"}
    rng = np.random.RandomState(0)
    x = torch.from_numpy(np.maximum(rng.randn(2, 37, 32), 0).astype("f"))
    oi = torch.from_numpy(rng.randint(0, 36, (2, 5, 37)))
    am = torch.zeros((2, 5, 37))
    am[..., :3] = 1
    out = G.gpn_test_forward(params, x, oi, am, cfg)
    assert out.scores.shape == (2, 5) and (out.scores == 1.0).all()


def test_nms_on_tied_scores_matches_jax():
    """All scores 1 (the Sup. model): the stable sort breaks ties by index,
    as jnp.argsort does, so the keep sets agree."""
    cfg, jcfg = P.ModelConfig(), JC.ModelConfig()
    rng = np.random.RandomState(1)
    for trial in range(6):
        S, N = 16, cfg.obj_num
        oi = np.full((S, N), N - 1, np.int64)
        am = np.zeros((S, N), np.float32)
        for s in range(S):
            k = rng.randint(2, 5)
            oi[s, :k] = rng.choice(8, k, replace=False)
            am[s, :k] = 1
        valid = rng.rand(S) > 0.2
        scores = np.ones(S, np.float32)
        for par in (True, False):
            ki, kv = G.subgraph_nms(*(torch.from_numpy(a) for a in
                                      (scores, oi, am, valid)),
                                    cfg, 0.5, 5, parallel=par)
            jki, jkv = JG.subgraph_nms(*map(jnp.asarray,
                                            (scores, oi, am, valid)),
                                       jcfg, 0.5, 5, parallel=par)
            np.testing.assert_array_equal(kv.numpy(), np.asarray(jkv))
            np.testing.assert_array_equal(ki.numpy(), np.asarray(jki))


@pytest.mark.parametrize("sct", [False, True])
def test_save_predictions_name(tmp_path, sct):
    preds = [{"image_id": 1, "caption": ["a dog"]}]
    path = P.save_predictions(preds, str(tmp_path), "7", sct=sct)
    assert path.endswith(("ctl_captions_7.npy" if sct
                          else "/captions_7.npy"))
    assert np.load(path, allow_pickle=True).tolist() == preds


def test_run_test_split_refuses_full_gc():
    cfg, ecfg, _ = P.build_configs("Full_GC_Kar")
    with pytest.raises(ValueError, match="Full-GC"):
        P.run_test_split({}, {}, None, cfg, ecfg, {}, device="cpu")
