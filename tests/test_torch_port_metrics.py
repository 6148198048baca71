"""The port's offline metrics against the JAX package's:

* ``eval/pairwise.py``: its plain versions (the Python paths) exactly
  equal to the JAX package with its native library switched off; its
  defaults (the C++ cores) within rtol 1e-10 of the JAX defaults (bitwise
  in ``tests/test_torch_port_native.py``);
* ``diversity_report``: equal, one RNG stream in the reference's order,
  both packages on their C++ mBLEU-4;
* ``controllability_scores`` with noun vectors drawn from a seed: equal;
* ``find_nn_images(device="cpu")``: the JAX indices, index for index, on
  integer-valued features (exact float32 distances) with duplicated train
  rows, so distance ties decide the order; and a float64 argsort with
  index tie-break;
* ``select_top_captions``, ``consensus_rerank``'s order and
  ``rerank_predictions``' top-1: equal, both packages on their C++
  pairwise CIDEr.
"""
import numpy as np
import pytest

import subgc_tpu.ops.native as JN
from subgc_tpu.eval import controllability as JC
from subgc_tpu.eval import diversity as JD
from subgc_tpu.eval import rerank as JR
from subgc_tpu_torch.eval import controllability as PC
from subgc_tpu_torch.eval import diversity as PD
from subgc_tpu_torch.eval import pairwise as PP
from subgc_tpu_torch.eval import rerank as PR

from .test_torch_port_scorers import _pairs, assert_same


@pytest.fixture
def jax_python_paths(monkeypatch):
    """The JAX package's scorer entry points without their C++ cores."""
    monkeypatch.setattr(JN, "_lib", None)
    monkeypatch.setattr(JN, "_tried", True)


def _sentences(n, seed):
    pairs = _pairs("corpus")
    rng = np.random.RandomState(seed)
    pool = [p["hyp"] for p in pairs] + [r for p in pairs for r in p["refs"]]
    return [pool[i] for i in rng.randint(0, len(pool), n)]


def _fanout_predictions(n_images=4, seed=0):
    """captions_*.npy-style predictions of the M-RNN fan-out: 30-120
    captions per image with repeats, sGPN scores in descending order."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n_images):
        n = rng.randint(30, 121)
        caps = _sentences(n // 3, seed + 10 * i)
        out.append({"image_id": i,
                    "caption": [caps[j] for j in rng.randint(0, len(caps),
                                                              n)],
                    "subgraph_score": np.sort(rng.rand(n))[::-1].tolist()})
    return out


# ------------------------------------------------------------ pairwise

@pytest.mark.parametrize("seed", [0, 1])
def test_pairwise_scorers_equal_jax_python_paths(jax_python_paths, seed):
    """The port's plain versions (its Python paths) against the JAX
    package's Python paths, exactly."""
    assert not JN.available()
    sents = _sentences(12, seed) + ["", "dog", "A man's dog, running!"]
    assert_same(PP.ptb_tokenize_batch_plain(sents),
                JN.ptb_tokenize_batch(sents))
    toks = PP.ptb_tokenize_batch_plain(sents[:12])
    docs = [toks[i:i + 3] for i in range(0, 12, 3)]
    hyps, refs = toks[:5], toks[5:] + ["zebra"]
    assert_same(PP.pairwise_cider_matrix_plain(docs, hyps, refs),
                JN.pairwise_cider_matrix(docs, hyps, refs))
    assert_same(PP.pairwise_cider_matrix_plain(docs, hyps, refs, sigma=3.0),
                JN.pairwise_cider_matrix(docs, hyps, refs, sigma=3.0))
    assert_same(PP.mutual_bleu4_plain(toks[:5]), JN.mutual_bleu4(toks[:5]))


@pytest.mark.parametrize("seed", [0, 1])
def test_pairwise_scorers_match_jax_native_cores(seed):
    if not JN.available():
        pytest.skip("the JAX package's C++ host library did not build")
    toks = PP.ptb_tokenize_batch(_sentences(12, seed))
    assert PP.ptb_tokenize_batch(toks) == JN.ptb_tokenize_batch(toks)
    docs = [toks[i:i + 3] for i in range(0, 12, 3)]
    np.testing.assert_allclose(
        PP.pairwise_cider_matrix(docs, toks[:5], toks[5:]),
        JN.pairwise_cider_matrix(docs, toks[:5], toks[5:]), rtol=1e-10)
    np.testing.assert_allclose(PP.mutual_bleu4(toks[:5]),
                               JN.mutual_bleu4(toks[:5]), rtol=1e-10)


# ------------------------------------------------------------ diversity

@pytest.mark.parametrize("mb4,train", [(True, True), (False, True),
                                       (True, False)])
def test_diversity_report_equals_jax(mb4, train):
    preds = _fanout_predictions()
    train_sents = _sentences(200, 7) + [preds[0]["caption"][0]] if train \
        else ()
    rep = PD.diversity_report(preds, train_sents, evaluate_mb4=mb4)
    assert_same(rep, JD.diversity_report(preds, train_sents,
                                         evaluate_mb4=mb4))
    assert ("mBLEU4" in rep) == mb4 and ("novel" in rep) == train
    assert all(0 <= x <= 1 for x in rep["distinct"] + rep.get("mBLEU4", []))


def test_diversity_mbleu4_matches_jax_native_core():
    preds = _fanout_predictions(seed=3)
    np.testing.assert_allclose(PD.mbleu4(preds), JD.mbleu4(preds),
                               rtol=1e-10)


# ------------------------------------------------------ controllability

def _ctl_inputs(seed=0):
    rng = np.random.RandomState(seed)
    words = sorted({w for s in _sentences(60, seed) for w in s.split()})
    nouns = {w: rng.randn(16) for w in words[::2]}
    preds, gts, order = [], [], []
    for i in range(6):
        n = rng.randint(2, 5)
        preds.append({"image_id": 40 + i, "caption": _sentences(n, i)})
        for g in range(n):
            gts.append(_sentences(rng.randint(1, 4), 100 + 10 * i + g))
        order.append(40 + i)
    return preds, order, gts, nouns


@pytest.mark.parametrize("spice", [True, False])
def test_controllability_scores_equal_jax(spice):
    preds, order, gts, nouns = _ctl_inputs()
    out = PC.controllability_scores(preds, order, gts, PC.NounIoU(nouns),
                                    use_spice=spice)
    assert_same(out, JC.controllability_scores(preds, order, gts,
                                               JC.NounIoU(nouns),
                                               use_spice=spice))
    assert np.isfinite(list(out.values())).all()
    assert ("SPICE" in out) == spice


def test_noun_iou_equals_jax():
    _, _, gts, nouns = _ctl_inputs(seed=1)
    p, j = PC.NounIoU(nouns), JC.NounIoU(nouns)
    sents = [s for g in gts for s in g] + ["", "zebra"]
    for a in sents[:12]:
        for b in sents:
            assert_same(p.score(a, b), j.score(a, b))


# ------------------------------------------------------------ NN search

def _int_feats(n_te, n_tr, dim, seed):
    """Integer-valued features in [-4, 4] (float32 distances are exact),
    with duplicated train rows and test rows equal to train rows."""
    rng = np.random.RandomState(seed)
    tr = rng.randint(-4, 5, (n_tr, dim)).astype(np.float32)
    tr[n_tr // 2:n_tr // 2 + n_tr // 4] = tr[:n_tr // 4]
    te = rng.randint(-4, 5, (n_te, dim)).astype(np.float32)
    te[:n_te // 4] = tr[rng.randint(0, n_tr, n_te // 4)]
    return te, tr


@pytest.mark.parametrize("num_nn,batch", [(1, 7), (10, 16), (60, 512),
                                          (1000, 32)])
def test_find_nn_images_equals_jax(num_nn, batch):
    te, tr = _int_feats(40, 300, 6, seed=num_nn)
    out = PR.find_nn_images(te, tr, num_nn=num_nn, batch=batch,
                            device="cpu")
    assert out.shape == (40, min(num_nn, 300))
    np.testing.assert_array_equal(
        out, JR.find_nn_images(te, tr, num_nn=num_nn, batch=batch))
    d = ((te[:, None].astype(np.float64) - tr[None]) ** 2).sum(-1)
    ref = np.lexsort((np.broadcast_to(np.arange(300), d.shape), d), axis=1)
    np.testing.assert_array_equal(out, ref[:, :out.shape[1]])


def test_find_nn_images_ties_come_in_index_order():
    """Every train row at the same distance: the order is the index order,
    also where the k-th value is shared by more rows than fit."""
    tr = np.zeros((50, 4), np.float32)
    tr[[3, 17, 40]] = 1.0
    te = np.zeros((3, 4), np.float32)
    out = PR.find_nn_images(te, tr, num_nn=10, device="cpu")
    expect = [i for i in range(50) if i not in (3, 17, 40)][:10]
    assert out.tolist() == [expect] * 3
    out = PR.find_nn_images(te + 1.0, tr, num_nn=5, device="cpu")
    assert out[0, :3].tolist() == [3, 17, 40]
    assert out[0, 3:].tolist() == [0, 1]


# ---------------------------------------------------- consensus rerank

def _rerank_inputs(seed=0):
    preds = _fanout_predictions(n_images=5, seed=seed)
    annos = [{"id": 900 + i, "sentences": _sentences(3, 50 + i)}
             for i in range(30)]
    te, tr = _int_feats(len(preds), len(annos), 8, seed)
    return preds, annos, te, tr


@pytest.mark.parametrize("rand_k", [None, 6])
def test_select_top_captions_equals_jax(rand_k):
    preds = _fanout_predictions(seed=2)
    assert_same(PR.select_top_captions(preds, top_k=4, rand_k=rand_k),
                JR.select_top_captions(preds, top_k=4, rand_k=rand_k))


@pytest.mark.parametrize("k,m", [(60, 125), (3, 4)])
def test_consensus_rerank_equals_jax(k, m):
    preds, annos, te, tr = _rerank_inputs()
    nn = PR.find_nn_images(te, tr, num_nn=20, device="cpu")
    df = {a["id"]: a["sentences"] for a in annos}
    ph = PR.select_top_captions(preds, top_k=4)
    jh = JR.select_top_captions(preds, top_k=4)
    assert_same(PR.consensus_rerank(ph, annos, nn, df, k=k, m=m),
                JR.consensus_rerank(jh, annos, nn, df, k=k, m=m))
    assert_same(ph, jh)          # each entry's "reranked" captions


def test_rerank_predictions_equals_jax():
    preds, annos, te, tr = _rerank_inputs(seed=1)
    df = {a["id"]: a["sentences"] for a in annos}
    p = PR.rerank_predictions(preds, annos, tr, te, df, top_k=3, k=5, m=9,
                              num_nn=12, device="cpu")
    assert_same(p, JR.rerank_predictions(preds, annos, tr, te, df, top_k=3,
                                         k=5, m=9, num_nn=12))
