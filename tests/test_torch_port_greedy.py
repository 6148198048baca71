"""The port's greedy / top-k decode, its two per-row attention layouts and
the grounding path, held against the JAX package.

Attention and logprobs within rtol/atol 1e-5 (float32, summation order);
greedy tokens, top-k masks, captions, sub-graph orders, grounding entries and
``FlickrGrdEval`` numbers exactly.  Top-k draws cannot match jax's PRNG, so
top-k is held to its selection rule: every drawn token lies in the k largest
tempered logprobs, and the recorded logprob is the tempered value there.
The CUDA kernel behind ``row_attention`` is checked against its plain version
on the card by ``tests/test_torch_port_kernels.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import subgc_tpu.config as JC
from subgc_tpu.config import EvalConfig as JEvalConfig
from subgc_tpu.data.dataset import EvalLoader as JEvalLoader
from subgc_tpu.data.synthetic import generate_dataset
from subgc_tpu.decode import greedy as JG
from subgc_tpu.eval import grounding as JGrd
from subgc_tpu.eval.runner import run_test_split as j_run_test_split
from subgc_tpu.models import decoder as JD
from subgc_tpu.models.params import init_params as j_init_params
from subgc_tpu.ops.pallas_attention import fused_attention
from subgc_tpu.utils import lemma as JL
import subgc_tpu_torch as P
from subgc_tpu_torch.config import EvalConfig, ModelConfig
from subgc_tpu_torch.decode import greedy as G
from subgc_tpu_torch.eval import grounding as Grd
from subgc_tpu_torch.models import decoder as D
from subgc_tpu_torch.models.params import params_from_numpy
from subgc_tpu_torch.ops import attention as A
from subgc_tpu_torch.utils import lemma as L

TOL = dict(rtol=1e-5, atol=1e-5)


def _port_cfg(jcfg):
    return ModelConfig(**{f: getattr(jcfg, f)
                          for f in ModelConfig.__dataclass_fields__})


def _port_params(tiny_params):
    return params_from_numpy(jax.tree_util.tree_map(np.array,
                                                    tiny_params[0]), "cpu")


def _weights(tiny_params):
    dec = tiny_params[0]["decoder"]
    return [np.array(a) for a in (dec["h2att"]["w"], dec["h2att"]["b"],
                                    dec["alpha_net"]["w"],
                                    dec["alpha_net"]["b"])]


def _feats(cfg, layout, S=6, G_=2, seed=0):
    """numpy decode features: per-row streams [S, N, *] with left-packed
    masks, or an image-shared fan-out over G_ images with node membership."""
    rng = np.random.RandomState(seed)
    n, R, H = cfg.obj_num, cfg.rnn_size, cfg.att_hid_size
    f = {"fc": rng.rand(S, R).astype("f"),
         "fc_ih": rng.uniform(-0.5, 0.5, (S, 4 * R)).astype("f")}
    if layout == "row":
        count = rng.randint(2, 9, (S, 1))
        f.update(att=rng.rand(S, n, R).astype("f"),
                 p_att=rng.randn(S, n, H).astype("f"),
                 mask=(np.arange(n)[None] < count).astype("f"))
    else:
        mask = (rng.rand(S, n) > 0.7).astype("f")
        mask[:, 0] = 1.0
        f.update(att=None, p_att=None, mask=mask,
                 att_img=rng.rand(G_, n, R).astype("f"),
                 p_att_img=rng.randn(G_, n, H).astype("f"),
                 img_ix=np.repeat(np.arange(G_), S // G_).astype(np.int32))
    return f


def _both(f):
    jf = JD.PreparedFeatures(**{k: None if v is None else jnp.asarray(v)
                                for k, v in f.items()})
    pf = D.PreparedFeatures(**{k: None if v is None else torch.from_numpy(v)
                               for k, v in f.items()})
    return jf, pf


# ---------------------------------------------------------------- attention

def test_row_attention_ref_matches_pallas_interpret(tiny_cfg, tiny_params):
    f = _feats(tiny_cfg, "row", S=7, seed=1)
    h = np.random.RandomState(2).uniform(
        -1, 1, (7, tiny_cfg.rnn_size)).astype("f")
    wts = _weights(tiny_params)
    j_out, j_w = fused_attention(*map(jnp.asarray, (h, f["p_att"], f["att"],
                                                    f["mask"], *wts)),
                                 block_r=4, interpret=True)
    out, w = A.row_attention_ref(*map(torch.from_numpy,
                                      (h, f["p_att"], f["att"], f["mask"],
                                       *wts)))
    np.testing.assert_allclose(w.numpy(), np.asarray(j_w), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)


@pytest.mark.parametrize("layout", ["row", "image"])
def test_per_row_query_attention_matches_jax(tiny_cfg, tiny_params, layout):
    """decoder.attention with h [S, R]: the per-row streams (through
    row_attention) and the image-shared fan-out (shared_attention at one
    beam), against the JAX decoder.attention."""
    f = _feats(tiny_cfg, layout, S=6, G_=3, seed=3)
    h = np.random.RandomState(4).uniform(
        -1, 1, (6, tiny_cfg.rnn_size)).astype("f")
    jf, pf = _both(f)
    j_out, j_w = JD.attention(tiny_params[0], jnp.asarray(h), jf, tiny_cfg)
    out, w = D.attention(_port_params(tiny_params), torch.from_numpy(h), pf,
                         _port_cfg(tiny_cfg))
    np.testing.assert_allclose(w.numpy(), np.asarray(j_w), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)


def test_row_layout_goes_through_the_row_wrapper(tiny_cfg, tiny_params,
                                                 monkeypatch):
    f = _feats(tiny_cfg, "row", S=4, seed=5)
    _, pf = _both(f)
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return A.row_attention_ref(*args)

    monkeypatch.setattr(D, "row_attention", spy)
    D.attention(_port_params(tiny_params),
                torch.zeros((4, tiny_cfg.rnn_size)), pf, _port_cfg(tiny_cfg))
    assert calls == [(4, tiny_cfg.rnn_size)]


def test_image_shared_fanout_single_image_layout(tiny_cfg, tiny_params):
    """att_img [n, *] without an image axis (one image): every row attends
    over that image's streams, as in the JAX package."""
    f = _feats(tiny_cfg, "image", S=5, G_=1, seed=6)
    f["att_img"], f["p_att_img"], f["img_ix"] = \
        f["att_img"][0], f["p_att_img"][0], None
    h = np.random.RandomState(7).uniform(
        -1, 1, (5, tiny_cfg.rnn_size)).astype("f")
    jf, pf = _both(f)
    j_out, j_w = JD.attention(tiny_params[0], jnp.asarray(h), jf, tiny_cfg)
    out, w = D.attention(_port_params(tiny_params), torch.from_numpy(h), pf,
                         _port_cfg(tiny_cfg))
    np.testing.assert_allclose(w.numpy(), np.asarray(j_w), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)


def test_image_shared_fanout_rejects_ungrouped_rows(tiny_cfg, tiny_params):
    f = _feats(tiny_cfg, "image", S=6, G_=3, seed=8)
    f["att_img"], f["p_att_img"] = f["att_img"][:2], f["p_att_img"][:2]
    h = np.zeros((7, tiny_cfg.rnn_size), "f")
    f["mask"] = np.ones((7, tiny_cfg.obj_num), "f")
    jf, pf = _both(f)
    with pytest.raises(ValueError, match="not divisible"):
        JD.attention(tiny_params[0], jnp.asarray(h), jf, tiny_cfg)
    with pytest.raises(ValueError, match="not divisible"):
        D.attention(_port_params(tiny_params), torch.from_numpy(h), pf,
                    _port_cfg(tiny_cfg))


# -------------------------------------------------------------- top-k mask

def test_topk_mask_ties_exact_cardinality_lowest_index():
    lp2 = np.asarray([[0.0, -1.0, -1.0, -2.0, -1.0, -1.0, -1.0, -5.0]], "f")
    m = G._topk_mask(torch.from_numpy(lp2), 3).numpy()
    kept = np.where(np.isfinite(m[0]))[0]
    np.testing.assert_array_equal(kept, [0, 1, 2])
    np.testing.assert_array_equal(m[0, kept], lp2[0, kept])
    np.testing.assert_array_equal(m, np.asarray(JG._topk_mask(
        jnp.asarray(lp2), 3)))


def test_topk_mask_fuzz_matches_jax():
    rng = np.random.RandomState(9)
    for _ in range(20):
        # coarse quantisation: many exact ties
        lp2 = (np.round(rng.randn(4, 30) * 2) / 2).astype("f")
        k = int(rng.randint(1, 6))
        m = G._topk_mask(torch.from_numpy(lp2), k).numpy()
        assert (np.isfinite(m).sum(-1) == k).all()
        np.testing.assert_array_equal(m, np.asarray(JG._topk_mask(
            jnp.asarray(lp2), k)))


# ------------------------------------------------------------------ sample

def _run_both(tiny_cfg, tiny_params, layout, jecfg, ecfg, seed=10, S=6):
    f = _feats(tiny_cfg, layout, S=S, G_=2, seed=seed)
    jf, pf = _both(f)
    j = JG.sample(tiny_params[0], jf, tiny_cfg, jecfg,
                  jax.random.PRNGKey(0))
    p = G.sample(_port_params(tiny_params), pf, _port_cfg(tiny_cfg), ecfg)
    return j, p, pf


@pytest.mark.parametrize("layout,return_att", [("row", True), ("row", False),
                                               ("image", False)])
def test_greedy_sample_matches_jax(tiny_cfg, tiny_params, layout, return_att):
    j, p, _ = _run_both(tiny_cfg, tiny_params, layout,
                        JEvalConfig(beam_size=1, return_att=return_att),
                        EvalConfig(beam_size=1, return_att=return_att))
    T, N = tiny_cfg.seq_length, tiny_cfg.obj_num
    assert p.att_weights.shape == (6, T + 1 if return_att else T, N)
    np.testing.assert_array_equal(p.seq.numpy(), np.asarray(j.seq))
    np.testing.assert_allclose(p.logprobs.numpy(), np.asarray(j.logprobs),
                               **TOL)
    np.testing.assert_allclose(p.att_weights.numpy(),
                               np.asarray(j.att_weights), **TOL)


@pytest.mark.parametrize("layout", ["row", "image"])
def test_topk_one_is_exact_against_jax(tiny_cfg, tiny_params, layout):
    kw = dict(beam_size=1, use_topk_sampling=True, the_k=1, topk_temp=0.6)
    j, p, _ = _run_both(tiny_cfg, tiny_params, layout, JEvalConfig(**kw),
                        EvalConfig(**kw), seed=11)
    np.testing.assert_array_equal(p.seq.numpy(), np.asarray(j.seq))
    np.testing.assert_allclose(p.logprobs.numpy(), np.asarray(j.logprobs),
                               **TOL)


def test_topk_draws_obey_the_selection_rule(tiny_cfg, tiny_params):
    """the_k=3: replaying the decode on the drawn tokens, every recorded
    logprob is one of the k largest tempered logprobs, and for a row still
    running it is the tempered logprob of the token drawn."""
    cfg, k, temp = _port_cfg(tiny_cfg), 3, 0.6
    ecfg = EvalConfig(beam_size=1, use_topk_sampling=True, the_k=k,
                      topk_temp=temp)
    _, pf = _both(_feats(tiny_cfg, "image", S=8, G_=2, seed=12))
    tp = _port_params(tiny_params)
    gen = torch.Generator().manual_seed(5)
    out = G.sample(tp, pf, cfg, ecfg, gen)
    state = D.init_state(8, cfg, "cpu")
    it = torch.zeros((8,), dtype=torch.int64)
    running = torch.ones((8,), dtype=torch.bool)
    for t in range(cfg.seq_length):
        lp, state, _ = D.decode_step(tp, state, it, pf, cfg)
        lp2 = torch.log_softmax(lp / temp, dim=-1)
        top = torch.sort(lp2, dim=-1, descending=True).values[:, :k]
        rec = out.logprobs[:, t]
        assert (rec[:, None] == top).any(-1).all()
        tok = out.seq[:, t]
        in_top = G._topk_mask(lp2, k).gather(1, tok[:, None])[:, 0]
        assert torch.isfinite(in_top[running]).all()
        assert torch.equal(lp2.gather(1, tok[:, None])[:, 0][running],
                           rec[running])
        running = running & (tok > 0)
        it = tok
    assert (out.logprobs <= 0).all() and torch.isfinite(out.logprobs).all()
    # the draws follow the generator: the same seed repeats them
    again = G.sample(tp, pf, cfg, ecfg, torch.Generator().manual_seed(5))
    assert torch.equal(again.seq, out.seq)


# ------------------------------------------------------- test split, e2e

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_greedy")
    return generate_dataset(str(root), n_images=20, vocab_size=50,
                            feat_dim=80, n_subgraphs=12, seed=4)


def _split_setup(synth, tiny_cfg, preset, bucket):
    over = dict(model={f: getattr(tiny_cfg, f) for f in
                       ("vocab_size", "rnn_size", "input_encoding_size",
                        "att_hid_size", "gcn_dim", "fc_feat_size",
                        "att_feat_size", "embed_dim", "num_obj_classes",
                        "num_rel_classes")})
    jcfg, jecfg, _ = JC.build_configs(preset, **over)
    cfg, ecfg, _ = P.build_configs(preset, **over)
    paths = dict(input_json=synth["input_json"],
                 input_label_h5=synth["input_label_h5"],
                 sg_dir=synth["sg_dir"], mask_dir=synth["mask_dir"])
    jloader = JEvalLoader(jcfg, JC.DataConfig(**paths), bucket=bucket)
    loader = P.EvalLoader(cfg, P.DataConfig(**paths), bucket=bucket)
    params, state = j_init_params(jax.random.PRNGKey(1), jcfg,
                                  n_obj_names=30, n_pred_names=10)
    tp = P.params_from_numpy(jax.tree_util.tree_map(np.array, params), "cpu")
    return (jcfg, jecfg, jloader, params), (cfg, ecfg, loader, tp), state


def _grounding_tables(loader):
    """word -> lemma -> class tables over the synthetic vocab (as
    tests/test_grounding_e2e.py builds them)."""
    words = list(loader.vocab.values())
    lemma_det = {w: i for i, w in enumerate(words[:10])}
    img_wh = {loader.ds.images[ix]["id"]: (640, 480)
              for ix in loader.split_ix["test"]}
    return ({w: w for w in words}, lemma_det,
            {i: w for w, i in lemma_det.items()}, img_wh)


def _same_predictions(preds, jpreds):
    assert len(preds) == len(jpreds) > 0
    for p, j in zip(preds, jpreds):
        assert p["image_id"] == j["image_id"]
        assert p["caption"] == j["caption"]
        np.testing.assert_array_equal(p["sorted_subgraph_ind"],
                                      j["sorted_subgraph_ind"])
        np.testing.assert_allclose(p["subgraph_score"], j["subgraph_score"],
                                   rtol=1e-5)


def test_grounding_split_matches_jax(synth, tiny_cfg):
    (jcfg, jecfg, jloader, params), (cfg, ecfg, loader, tp), state = \
        _split_setup(synth, tiny_cfg, "Sub_GC_Flickr_GRD", bucket=16)
    assert (ecfg.beam_size, ecfg.return_att, ecfg.gpn_max_subg) == \
        (1, True, 10)
    tables = _grounding_tables(loader)
    jcol = JGrd.GroundingCollector(*tables)
    col = P.GroundingCollector(*tables)
    jpreds, _, _ = j_run_test_split(params, state, jloader, jcfg, jecfg,
                                    jloader.vocab, verbose=False,
                                    collect_grounding=jcol, batch_images=3)
    preds, _, _ = P.run_test_split(tp, state, loader, cfg, ecfg, loader.vocab,
                                   verbose=False, collect_grounding=col,
                                   batch_images=3, device="cpu")
    _same_predictions(preds, jpreds)
    assert dict(col.output) == dict(jcol.output)
    assert sum(len(e[0]["clss"]) for e in col.output.values()) > 0
    # a reference built from the collected boxes scores the same in both
    ref = [{"image_id": int(i), "captions": [{
        "process_bnd_box": [[e[0]["bbox"][0]]],
        "process_idx": [e[0]["idx_in_sent"][0]],
        "process_clss": [e[0]["clss"][0]],
        "tokens": ["a"] * (e[0]["idx_in_sent"][0] + 1)}]}
        for i, e in col.output.items() if e[0]["clss"]]
    for mode in ("all", "loc"):
        got = P.FlickrGrdEval(ref, dict(col.output)).grd_eval(mode)
        assert got == JGrd.FlickrGrdEval(ref, dict(jcol.output)).grd_eval(mode)
        assert got[f"recall_{mode}"] > 0


def test_mrnn_fanout_split_matches_jax(synth, tiny_cfg):
    (jcfg, jecfg, jloader, params), (cfg, ecfg, loader, tp), state = \
        _split_setup(synth, tiny_cfg, "Sub_GC_MRNN", bucket=12)
    assert (ecfg.beam_size, ecfg.gpn_nms_thres, ecfg.gpn_max_subg) == \
        (1, 0.55, 1000)
    jpreds, _, jn = j_run_test_split(params, state, jloader, jcfg, jecfg,
                                     jloader.vocab, verbose=False,
                                     batch_images=2)
    preds, _, n = P.run_test_split(tp, state, loader, cfg, ecfg, loader.vocab,
                                   verbose=False, batch_images=2,
                                   device="cpu")
    assert n == jn
    _same_predictions(preds, jpreds)


# ------------------------------------------------- grounding copies, lemma

@pytest.mark.parametrize("case", ["overlap", "disjoint", "nested", "one_row"])
def test_box_iou_matches_jax(case):
    rng = np.random.RandomState(13)
    box = np.asarray([10.0, 20.0, 60.0, 90.0])
    refs = {"overlap": rng.rand(6, 4) * 50 + [[0, 0, 40, 40]],
            "disjoint": np.asarray([[100.0, 100.0, 120.0, 130.0]]),
            "nested": np.asarray([[20.0, 30.0, 40.0, 50.0], box]),
            "one_row": np.asarray([15.0, 25.0, 55.0, 80.0])}[case]
    np.testing.assert_array_equal(Grd.box_iou(box, refs),
                                  JGrd.box_iou(box, refs))


@pytest.mark.parametrize("mode", ["all", "loc"])
def test_grd_eval_empty_reference(mode):
    for ref, pred in (([], {}), ([], {"1": [{"clss": ["dog"],
                                             "idx_in_sent": [0],
                                             "bbox": [[0, 0, 5, 5]]}]})):
        assert P.FlickrGrdEval(ref, pred).grd_eval(mode) == \
            JGrd.FlickrGrdEval(ref, pred).grd_eval(mode) == \
            {f"precision_{mode}": 0.0, f"recall_{mode}": 0.0,
             f"F1_{mode}": 0.0}


def test_lemma_copy_matches_jax():
    words = (list(JL.IRREGULAR) + sorted(JL._KEEP_S) + sorted(JL._KEEP_ING)
             + [w + s for w in ("dog", "bench", "ride", "sit", "pony")
                for s in ("", "s", "es", "ing", "ed", "ies")])
    assert [L.lemmatize(w) for w in words] == \
        [JL.lemmatize(w) for w in words]


def test_grounding_cli_scores_a_submission(tmp_path):
    import json
    from subgc_tpu_torch.cli import grounding as cli
    ref = [{"image_id": 1, "captions": [{
        "process_bnd_box": [[[0, 0, 10, 10]]], "process_idx": [1],
        "process_clss": ["dog"], "tokens": ["a", "dog"]}]}]
    sub = {"results": {"1": [{"clss": ["dog"], "idx_in_sent": [1],
                              "bbox": [[0, 0, 10, 10]]}]}}
    (tmp_path / "ref.json").write_text(json.dumps(ref))
    (tmp_path / "sub.json").write_text(json.dumps(sub))
    out = cli.main(["--reference", str(tmp_path / "ref.json"),
                    "--submission", str(tmp_path / "sub.json")])
    assert out["F1_all"] == out["F1_loc"] == 1.0
