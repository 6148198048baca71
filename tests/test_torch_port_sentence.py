"""The port's ``eval/sentence.py`` against the JAX package's:
``align_predictions`` + ``language_eval`` on fixed ranked caption sets at
``oracle_num`` 1 and 3.  The whole ``all_scores`` dict is equal (per-rank
score matrices, ``top1``, ``oracle``, ``bleu_dict``,
``subgraph_bleu_material``, ``image_id_list``), and so are the
``.cache_<model>_<split><rank>.json`` dumps, byte for byte.
"""
import json
import os

import numpy as np
import pytest

from subgc_tpu.eval import sentence as J
from subgc_tpu_torch.eval import sentence as P

from .test_torch_port_scorers import _pairs, assert_same


def _ranked_sets(n_images=24, seed=0):
    """Predictions with 1-4 ranked captions per image (short lists exercise
    the padding) and GT for every image but the last (left out of the
    scores), drawn from the metric-validation corpus."""
    pairs = _pairs("corpus")
    rng = np.random.RandomState(seed)
    preds, gts = [], {}
    for i in range(n_images):
        pool = [p["hyp"] for p in pairs[4 * i:4 * i + 4]] \
            + pairs[4 * i]["refs"]
        n = rng.randint(1, 5)
        preds.append({"image_id": 100 + i,
                      "caption": [pool[j] for j in
                                  rng.choice(len(pool), n, replace=False)]})
        if i < n_images - 1:
            gts[100 + i] = pairs[4 * i + rng.randint(4)]["refs"]
    return preds, gts


@pytest.mark.parametrize("oracle_num", [1, 3])
def test_align_predictions_equals_jax(oracle_num):
    preds, _ = _ranked_sets()
    out = P.align_predictions(preds, oracle_num)
    assert_same(out, J.align_predictions(preds, oracle_num))
    assert all(len(p["caption"]) == oracle_num for p in out)


@pytest.mark.parametrize("oracle_num", [1, 3])
@pytest.mark.parametrize("spice", [True, False])
def test_language_eval_equals_jax(tmp_path, capsys, oracle_num, spice):
    preds, gts = _ranked_sets(seed=oracle_num)
    aligned = P.align_predictions(preds, oracle_num)
    kw = dict(use_spice=spice, use_meteor=spice, model_id="Sub_GC_Kar",
              split="test")
    p = P.language_eval(gts, aligned, cache_dir=str(tmp_path / "p"), **kw)
    p_out = capsys.readouterr().out
    j = J.language_eval(gts, aligned, cache_dir=str(tmp_path / "j"), **kw)
    assert p_out == capsys.readouterr().out
    assert_same(p, j)
    assert len(p["image_id_list"]) == len(gts)
    assert ("oracle" in p) == ("bleu_dict" in p) == (oracle_num > 1)
    for rank in range(oracle_num):
        name = f".cache_Sub_GC_Kar_test{rank}.json"
        with open(tmp_path / "p" / name, "rb") as f, \
                open(tmp_path / "j" / name, "rb") as g:
            assert f.read() == g.read()
    assert sorted(os.listdir(tmp_path / "p")) == \
        sorted(os.listdir(tmp_path / "j"))


def test_oracle_bleu_equals_jax():
    preds, gts = _ranked_sets(seed=5)
    scores = P.language_eval(gts, P.align_predictions(preds, 3),
                             use_spice=False, use_meteor=False,
                             verbose=False)
    mats = scores["subgraph_bleu_material"]
    for best in (np.zeros(len(gts), int),
                 np.argmax(scores["Bleu_4"], axis=0),
                 np.random.RandomState(1).randint(0, 3, len(gts))):
        assert_same(P.oracle_bleu(best, mats), J.oracle_bleu(best, mats))
    assert P.count_bad("a man on the") == J.count_bad("a man on the") == 1


def test_language_eval_cache_is_json_of_the_rank(tmp_path):
    preds, gts = _ranked_sets(seed=2)
    aligned = P.align_predictions(preds, 2)
    cache = str(tmp_path)
    P.language_eval(gts, aligned, use_spice=False, use_meteor=False,
                    verbose=False, cache_dir=cache, model_id="m", split="v")
    with open(os.path.join(cache, ".cache_m_v1.json")) as f:
        dump = json.load(f)
    assert dump == [{"image_id": p["image_id"], "caption": p["caption"][1]}
                    for p in aligned if p["image_id"] in gts]
