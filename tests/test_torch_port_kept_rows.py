"""Decoding only the kept rows: ``eval/runner.py::_decode`` with ``keep``
gathers the rows NMS kept (under SCT the real region sets), decodes them,
and puts the outputs back into the ``[S, ...]`` row layout, zeros in the
rows it left out.

Each case holds the compacted decode against a decode of every row of the
same features: the kept rows' tokens equal, their log-probs and attention
weights within 1e-6, the other rows zero; top-k draws the same tokens, and
leaves its generator in the same state, whatever rows are left out and
however the rows shard.  On a card: a keep-1,000 fan-out dispatch both
ways, and the split-TF32 GEMM taken by the kept rows' count.

This file imports neither jax nor the JAX package, so its ``cuda`` test
runs on a GPU machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_port_kept_rows.py
"""
import numpy as np
import pytest
import torch

from subgc_tpu_torch.config import EvalConfig, ModelConfig, build_configs
from subgc_tpu_torch.eval import runner as R
from subgc_tpu_torch.graph import SceneGraph, SubgraphSet, to_device
from subgc_tpu_torch.models import decoder as D
from subgc_tpu_torch.models import subgc
from subgc_tpu_torch.models.params import init_params_numpy, params_from_numpy
from subgc_tpu_torch.ops import gemm as GM
from subgc_tpu_torch.parallel import mesh as M

TINY = dict(vocab_size=20, rnn_size=64, input_encoding_size=48,
            att_hid_size=32, gcn_dim=40, fc_feat_size=64, att_feat_size=80,
            embed_dim=20, num_obj_classes=30, num_rel_classes=10,
            obj_num=12, seq_length=5)
SLOTS = 5                       # keep slots an image
KEPT = (5, 2, 0, 3)             # each image's kept prefix: full, some, none


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread at these tiny widths: the test workers share the
    cores, and one thread per core oversubscribes them.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _feats(cfg, params, image_shared, seed=0, n=12, slots=SLOTS,
           images=len(KEPT)):
    rng = np.random.RandomState(seed)
    x_obj = torch.from_numpy(np.maximum(rng.randn(images, n, cfg.gcn_dim), 0)
                             .astype("f"))
    fc = torch.from_numpy(rng.randn(images, slots, 2 * cfg.gcn_dim)
                          .astype("f"))
    oi = torch.from_numpy(rng.randint(0, n, (images, slots, 4)))
    am = torch.ones((images, slots, 4))
    with torch.no_grad():
        f = D.prepare_features_nodes(params, fc, x_obj, oi, am, cfg,
                                     image_shared=image_shared)
    S = images * slots

    def flat(x):
        return None if x is None else x.reshape((S,) + x.shape[2:])

    return D.PreparedFeatures(
        fc=flat(f.fc), att=flat(f.att), p_att=flat(f.p_att),
        mask=flat(f.mask), fc_ih=flat(f.fc_ih), att_img=f.att_img,
        p_att_img=f.p_att_img,
        img_ix=(torch.arange(images).repeat_interleave(slots)
                if image_shared else None))


def _keep(kept=KEPT, slots=SLOTS):
    return (torch.arange(slots)[None] < torch.tensor(kept)[:, None]) \
        .reshape(-1)


def _tiny(seed=0):
    cfg = ModelConfig(compute_dtype="float32", **TINY)
    p, _ = init_params_numpy(cfg, seed=seed)
    return cfg, params_from_numpy(p, "cpu")


def _gen():
    return torch.Generator().manual_seed(2019)


def _every(feats):
    """A keep mask of every row: the decode of every row."""
    return torch.ones(feats.fc.shape[0], dtype=torch.bool,
                      device=feats.fc.device)


def _same_kept_rows(got, want, keep):
    """``got``: the compacted decode; ``want``: every row's."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        assert not g[~keep].any(), f"{k}: a row left out is not zero"
        if w.dtype.is_floating_point:
            torch.testing.assert_close(g[keep], w[keep], rtol=0, atol=1e-6)
        else:
            assert torch.equal(g[keep], w[keep]), k


CASES = {
    "greedy": dict(beam_size=1),
    "topk": dict(beam_size=1, use_topk_sampling=True, the_k=3),
    "beam2": dict(beam_size=2),
    "return_att": dict(beam_size=1, return_att=True),
    "verbose_beam": dict(beam_size=2, verbose_beam=1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kept_rows_decode_as_in_a_decode_of_every_row(case):
    cfg, params = _tiny()
    ecfg = EvalConfig(**CASES[case])
    # attention capture decodes over per-row streams, as in the runner
    feats = _feats(cfg, params, image_shared=not ecfg.return_att)
    keep = _keep()
    g_all, g_kept = _gen(), _gen()
    want = R._decode(params, feats, _every(feats), cfg, ecfg, g_all)
    got = R._decode(params, feats, keep, cfg, ecfg, g_kept)
    _same_kept_rows(got, want, keep)
    assert torch.equal(g_kept.get_state(), g_all.get_state())


@pytest.mark.parametrize("bucket", [4, 8, 32])
@pytest.mark.parametrize("image_shared", [True, False])
def test_bucketed_beam_rows_decode_as_in_a_decode_of_every_row(
        bucket, image_shared, monkeypatch):
    """A beam search on the card gathers its kept rows in buckets, padded
    by repeats of the first kept row (``runner.BEAM_ROW_BUCKET``); forced
    here on the CPU, the kept rows decode as in a decode of every row and
    the search sees the bucket's rows (at most every row)."""
    cfg, params = _tiny(seed=3)
    ecfg = EvalConfig(**CASES["verbose_beam"])
    feats = _feats(cfg, params, image_shared=image_shared)
    keep = _keep()
    want = R._decode(params, feats, _every(feats), cfg, ecfg)
    seen = []
    search = R.beam_mod.beam_search

    def record(params, feats, cfg, ecfg):
        seen.append(feats.fc.shape[0])
        return search(params, feats, cfg, ecfg)

    monkeypatch.setattr(R, "_row_bucket", lambda feats, ecfg: bucket)
    monkeypatch.setattr(R.beam_mod, "beam_search", record)
    got = R._decode(params, feats, keep, cfg, ecfg)
    n, S = int(keep.sum()), feats.fc.shape[0]
    assert seen == [min(-(-n // bucket) * bucket, S)]
    _same_kept_rows(got, want, keep)


@pytest.mark.parametrize("case", ["greedy", "beam2"])
def test_every_row_kept_gathers_nothing(case, monkeypatch):
    cfg, params = _tiny(seed=1)
    ecfg = EvalConfig(**CASES[case])
    feats = _feats(cfg, params, image_shared=True)
    want = R._decode_rows(params, feats, cfg, ecfg, None, None)

    def refuse(*a):
        raise AssertionError("gathered rows though every row is kept")

    monkeypatch.setattr(R, "_take_rows", refuse)
    got = R._decode(params, feats, _every(feats), cfg, ecfg)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_nothing_kept_gives_zero_rows():
    cfg, params = _tiny(seed=2)
    ecfg = EvalConfig(**CASES["return_att"])
    feats = _feats(cfg, params, image_shared=False)
    want = R._decode(params, feats, _every(feats), cfg, ecfg)
    got = R._decode(params, feats, ~_every(feats), cfg, ecfg)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        assert not got[k].any(), k


@pytest.mark.parametrize("at", [(3, 40), (torch.tensor([5, 0, 7]), 12)])
def test_draws_are_those_of_the_whole_row_shape(at):
    """``draw_categorical(rows=(at, total))``: an offset's rows, or an
    index's, of the ``total``-row draw."""
    logits = torch.randn(3, 9)
    whole = torch.randn(at[1], 9)
    rows = torch.arange(3) + at[0] if isinstance(at[0], int) else at[0]
    whole[rows] = logits
    want = D.draw_categorical(whole, _gen())[rows]
    got = D.draw_categorical(logits, _gen(), rows=at)
    assert torch.equal(got, want)


# ---- through the runner: encoder, sGPN, NMS or SCT, then the decode

WIDTHS = dict(vocab_size=20, rnn_size=64, input_encoding_size=48,
              att_hid_size=32, gcn_dim=40, fc_feat_size=64,
              att_feat_size=80, embed_dim=20, num_obj_classes=30,
              num_rel_classes=10)
BUCKET = 12


def _images(cfg, n_images, bucket, seed, real=None):
    """Stacked host arrays of ``n_images`` synthetic images; ``real``:
    each image's count of real sub-graph slots (the rest padding)."""
    rng = np.random.RandomState(seed)
    N, K = cfg.obj_num, cfg.rel_num
    graph = SceneGraph(
        obj_fmap=rng.rand(n_images, N, cfg.att_feat_size).astype("f"),
        obj_dist=rng.rand(n_images, N, cfg.num_obj_classes).astype("f"),
        rel_ind=rng.randint(0, N - 1, (n_images, K, 2)).astype(np.int32),
        pred_dist=rng.rand(n_images, K, cfg.num_rel_classes).astype("f"))
    obj_ind = np.full((n_images, bucket, N), N - 1, np.int32)
    att_mask = np.zeros((n_images, bucket, N), np.float32)
    for b in range(n_images):
        # sub-graphs drawn from fewer nodes overlap more: NMS keeps fewer
        pool = min(N - 1, 8 + 10 * b)
        for s in range(bucket):
            n = rng.randint(2, 8)
            obj_ind[b, s, :n] = rng.choice(pool, n, replace=False)
            att_mask[b, s, :n] = 1
    valid = np.ones((n_images, bucket), bool)
    if real is not None:
        valid = np.arange(bucket)[None] < np.asarray(real)[:, None]
        att_mask[~valid] = 0
        att_mask[~valid, 0] = 1
    subs = SubgraphSet(obj_ind=obj_ind,
                       pred_ind=np.full((n_images, bucket, K), K - 1,
                                        np.int32),
                       att_mask=att_mask, valid=valid)
    return graph, subs


def _preset(name, seed=0):
    cfg, ecfg, _ = build_configs(name, model=WIDTHS,
                                 eval=dict(max_subgraph_bucket=BUCKET))
    p, s = init_params_numpy(cfg, seed=seed)
    return cfg, ecfg, params_from_numpy(p, "cpu"), params_from_numpy(s, "cpu")


def _every_row(params, state, graph, subs, cfg, ecfg, generator):
    """The runner's dispatch with every keep slot decoded."""
    with torch.no_grad():
        enc = subgc.encode_images_batched(params, state, graph, subs, cfg,
                                          ecfg)
        res = R._decode(params, enc.feats, _every(enc.feats), cfg, ecfg,
                        generator)
    return enc.keep_valid, res


def test_sct_batch_decodes_its_real_region_sets():
    cfg, ecfg, params, state = _preset("Sub_GC_Flickr_CTL")
    real = (12, 3, 7, 1)
    graph, subs = (to_device(x, "cpu") for x in _images(
        cfg, len(real), BUCKET, seed=3, real=real))
    keep, want = _every_row(params, state, graph, subs, cfg, ecfg, None)
    assert torch.equal(keep, subs.valid.reshape(-1))
    got = R.make_batched_infer_fn(cfg, ecfg)(params, state, graph, subs)
    got = {k: got[k].reshape((-1,) + got[k].shape[2:]) for k in want}
    _same_kept_rows(got, want, keep)


@pytest.mark.parametrize("axis", ["subgraph", "image"])
def test_topk_sharded_kept_rows_equal_the_unsharded_decode(axis):
    """Sub_GC_S_MRNN over two CPU mesh entries: the kept rows split
    unevenly between them, the tokens and log-probs are the unsharded
    run's, and both are a decode of every row's at the kept rows."""
    cfg, ecfg, params, state = _preset("Sub_GC_S_MRNN", seed=4)
    B = 3
    graph_np, subs_np = _images(cfg, B, BUCKET, seed=5)
    graph, subs = to_device(graph_np, "cpu"), to_device(subs_np, "cpu")
    keep, every = _every_row(params, state, graph, subs, cfg, ecfg, _gen())
    halves = [int(c.sum()) for c in torch.tensor_split(
        keep if axis == "subgraph" else keep.reshape(B, -1), 2)]
    assert halves[0] != halves[1] and 0 < keep.sum() < keep.numel(), halves

    unsharded = R.make_batched_infer_fn(cfg, ecfg)(params, state, graph,
                                                   subs, _gen())
    mesh = M.make_mesh(devices=["cpu"] * 2)
    params_m, state_m = M.replicate(mesh, params), M.replicate(mesh, state)
    g = _gen()
    if axis == "subgraph":
        run = R.make_batched_infer_fn(cfg, ecfg, mesh=mesh)
        sharded = run(params_m, state_m, graph, subs, g)
    else:
        run = R.make_batched_infer_fn(cfg, ecfg)
        sharded = R._infer_image_sharded(run, params_m, state_m, graph_np,
                                         subs_np, mesh, g)
    for k in ("seq", "keep_valid"):
        assert torch.equal(sharded[k], unsharded[k]), k
    # the CPU's products round a row by how many rows share the call
    torch.testing.assert_close(sharded["logprobs"], unsharded["logprobs"],
                               rtol=0, atol=1e-6)
    g_every = _gen()
    _every_row(params, state, graph, subs, cfg, ecfg, g_every)
    assert torch.equal(g.get_state(), g_every.get_state())
    got = {k: unsharded[k].reshape((-1,) + unsharded[k].shape[2:])
           for k in every}
    _same_kept_rows(got, every, keep)


# ---- on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("per_image", [(304,) * 16, (60,) * 16])
def test_keep1000_fanout_dispatch_kept_rows_on_card(per_image):
    """A 16-image Sub_GC_MRNN dispatch at published widths, 1,000 keep
    slots an image (16,000 rows), decoded both ways: every slot, and only
    the kept prefix of each image (4,864 rows, or 960).  The kept rows'
    tokens are equal and their log-probs within 1e-5; the compacted decode
    takes the split-TF32 GEMM, 7 launches a step, from
    ``SPLIT_GEMM_MIN_ROWS`` kept rows and not below."""
    dev = _card()
    cfg = build_configs("Sub_GC_MRNN", vocab_size=9487)[0]
    p, _ = init_params_numpy(cfg, seed=7)
    params = params_from_numpy(p, dev)
    B_, K_, n, N = len(per_image), 1000, 36, 10
    # uneven kept counts: each image's count moves by up to 16 either way
    kept = [k + (i % 5 - 2) * 8 for i, k in enumerate(per_image)]
    rng = np.random.RandomState(7)
    x_obj = torch.from_numpy(np.maximum(rng.randn(B_, n, cfg.gcn_dim), 0)
                             .astype("f") * 0.1).to(dev)
    fc = torch.from_numpy(rng.randn(B_, K_, 2 * cfg.gcn_dim).astype("f")
                          * 0.1).to(dev)
    oi = torch.from_numpy(rng.randint(0, n, (B_, K_, N))).to(dev)
    am = torch.from_numpy((rng.rand(B_, K_, N) < 0.6).astype("f")).to(dev)
    am[..., 0] = 1.0
    with torch.no_grad():
        f = D.prepare_features_nodes(params, fc, x_obj, oi, am, cfg,
                                     image_shared=True)
    S = B_ * K_
    feats = D.PreparedFeatures(
        fc=f.fc.reshape(S, -1), att=None, p_att=None,
        mask=f.mask.reshape(S, -1), fc_ih=f.fc_ih.reshape(S, -1),
        att_img=f.att_img, p_att_img=f.p_att_img,
        img_ix=torch.arange(B_, device=dev).repeat_interleave(K_))
    keep = _keep(kept, K_).to(dev)
    ecfg = EvalConfig(beam_size=1)
    want = R._decode(params, feats, _every(feats), cfg, ecfg)
    GM.reset_launch_counts()
    got = R._decode(params, feats, keep, cfg, ecfg)
    torch.cuda.synchronize()
    rows = int(keep.sum())
    assert GM.GEMM_LAUNCHES == (7 * cfg.seq_length
                                if rows >= D.SPLIT_GEMM_MIN_ROWS else 0)
    assert torch.equal(got["seq"][keep], want["seq"][keep])
    torch.testing.assert_close(got["logprobs"][keep], want["logprobs"][keep],
                               rtol=0, atol=1e-5)
    assert not got["seq"][~keep].any() and not got["logprobs"][~keep].any()
