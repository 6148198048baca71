"""The port's caption scorers (``subgc_tpu_torch/eval``) against the JAX
package's, exactly equal: the PTB tokenizer, BLEU 1-4 (corpus, per image
and the oracle material), CIDEr-D, ``PairwiseCider``, ROUGE-L, METEOR, the
Porter stemmer, SPICE, the SPICE tuple oracle and ``CaptionEvaluator``.

Inputs: the 250 hypothesis / reference pairs of
``tests/data/metric_validation.json``, and hand-made edge cases (an empty
hypothesis, one-word sentences, no n-gram overlap, raw punctuation).
"""
import json
import math
import os

import numpy as np
import pytest

import subgc_tpu.eval.bleu as JB
import subgc_tpu.eval.cider as JCI
import subgc_tpu.eval.coco_eval as JCO
import subgc_tpu.eval.meteor as JM
import subgc_tpu.eval.rouge as JR
import subgc_tpu.eval.spice as JS
import subgc_tpu.eval.spice_oracle as JSO
import subgc_tpu.eval.stemmer as JST
import subgc_tpu.eval.tokenizer as JT
import subgc_tpu_torch.eval.bleu as PB
import subgc_tpu_torch.eval.cider as PCI
import subgc_tpu_torch.eval.coco_eval as PCO
import subgc_tpu_torch.eval.meteor as PM
import subgc_tpu_torch.eval.rouge as PR
import subgc_tpu_torch.eval.spice as PS
import subgc_tpu_torch.eval.spice_oracle as PSO
import subgc_tpu_torch.eval.stemmer as PST
import subgc_tpu_torch.eval.tokenizer as PT

HERE = os.path.dirname(os.path.abspath(__file__))

EDGE = [
    {"hyp": "", "refs": ["a dog runs on the grass", "a brown dog"]},
    {"hyp": "dog", "refs": ["dog", "a dog"]},
    {"hyp": "zebra", "refs": ["a man riding a horse on the beach"]},
    {"hyp": "purple elephants juggle quietly",
     "refs": ["a man riding a horse on the beach", "two cats sleeping"]},
    {"hyp": "A man's dog, running! (fast)...",
     "refs": ["The man's dog -- running fast.", "a dog isn't slow; it runs"]},
    {"hyp": "a man riding a horse on the beach",
     "refs": ["a man riding a horse on the beach"]},
    {"hyp": "a woman looking at a painting in a museum",
     "refs": ["a woman is looking at paintings", "people in a museum"]},
]


def assert_same(a, b, path="out"):
    """Exact structural equality: dicts, sequences, sets, numpy arrays (same
    dtype and values) and floats bit for bit (NaN equal to NaN)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype \
            and a.shape == b.shape, path
        if a.dtype == object:
            for i, (x, y) in enumerate(zip(a.ravel(), b.ravel())):
                assert_same(x, y, f"{path}.flat[{i}]")
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        assert math.isnan(b), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _pairs(which):
    if which == "edge":
        return EDGE
    with open(os.path.join(HERE, "data", "metric_validation.json")) as f:
        return json.load(f)["corpus"]


def _outcome(fn, *args, **kw):
    """fn's result, or its exception's type and message."""
    try:
        return fn(*args, **kw)
    except Exception as e:      # both packages must fail alike
        return ("raised", type(e).__name__, str(e))


def _raw(which):
    pairs = _pairs(which)
    gts = {i: p["refs"] for i, p in enumerate(pairs)}
    res = {i: p["hyp"] for i, p in enumerate(pairs)}
    return gts, res


def _tokenized(which, tok=PT.tokenize):
    gts, res = _raw(which)
    return (tok({k: [{"caption": c} for c in v] for k, v in gts.items()}),
            tok({k: [{"caption": c}] for k, c in res.items()}))


@pytest.fixture(params=["corpus", "edge"])
def which(request):
    return request.param


def test_tokenizer_equals_jax(which):
    gts, res = _raw(which)
    batch = {k: [{"caption": c} for c in v + [res[k]]]
             for k, v in gts.items()}
    assert_same(PT.tokenize(batch), JT.tokenize(batch))
    for lower in (True, False):
        for k, v in gts.items():
            for s in v + [res[k]]:
                assert_same(PT.ptb_tokenize_sentence(s, lower),
                            JT.ptb_tokenize_sentence(s, lower))


def test_bleu_equals_jax(which):
    gts, res = _tokenized(which)
    out = _outcome(PB.compute_bleu, gts, res)
    assert_same(out, _outcome(JB.compute_bleu, gts, res))
    if out[0] != "raised":
        m = out[2]
        assert_same(PB.bleu_from_components(sum(m["testlen"]),
                                            float(sum(m["reflen"])),
                                            [sum(g) for g in m["guess"]],
                                            [sum(c) for c in m["correct"]]),
                    JB.bleu_from_components(sum(m["testlen"]),
                                            float(sum(m["reflen"])),
                                            [sum(g) for g in m["guess"]],
                                            [sum(c) for c in m["correct"]]))


def test_cider_equals_jax(which):
    gts, res = _tokenized(which)
    assert_same(_outcome(PCI.compute_cider, gts, res),
                _outcome(JCI.compute_cider, gts, res))


def test_pairwise_cider_sim_equals_jax(which):
    gts, res = _tokenized(which)
    docs = list(gts.values())
    p, j = PCI.PairwiseCider(docs), JCI.PairwiseCider(docs)
    for k, refs in gts.items():
        h = res[k][0]
        for r in refs:
            assert_same(p.sim(p.vec(h), p.vec(r)), j.sim(j.vec(h), j.vec(r)))
            assert_same(p.score(h, r), j.score(h, r))


def test_rouge_equals_jax(which):
    gts, res = _tokenized(which)
    assert_same(_outcome(PR.compute_rouge, gts, res),
                _outcome(JR.compute_rouge, gts, res))


def test_meteor_equals_jax(which):
    gts, res = _tokenized(which)
    assert_same(_outcome(PM.compute_meteor, gts, res),
                _outcome(JM.compute_meteor, gts, res))
    for k, refs in gts.items():
        assert_same(PM.meteor_sentence(res[k][0], refs, [1.0, 1.0]),
                    JM.meteor_sentence(res[k][0], refs, [1.0, 1.0]))


def test_stemmer_equals_jax(which):
    gts, res = _tokenized(which)
    words = sorted({w for v in list(gts.values()) + list(res.values())
                    for s in v for w in s.split()})
    assert [PST.porter_stem(w) for w in words] == \
        [JST.porter_stem(w) for w in words]


def test_spice_equals_jax(which):
    gts, res = _tokenized(which)
    assert_same(_outcome(PS.compute_spice, gts, res),
                _outcome(JS.compute_spice, gts, res))
    for k in gts:
        assert_same(PS.parse_tuples(res[k][0]), JS.parse_tuples(res[k][0]))


def test_spice_oracle_equals_jax(which):
    gts, res = _raw(which)
    for k, refs in gts.items():
        for s in refs + [res[k]]:
            assert_same(PSO.oracle_tuples(s), JSO.oracle_tuples(s))
        assert_same(PSO.spice_sentence_oracle(res[k], refs),
                    JSO.spice_sentence_oracle(res[k], refs))


@pytest.mark.parametrize("spice,meteor", [(True, True), (False, False)])
def test_caption_evaluator_equals_jax(which, spice, meteor):
    gts, res = _raw(which)
    ids = list(gts)[::-1]
    p = PCO.CaptionEvaluator(gts, ids, spice, meteor)
    j = JCO.CaptionEvaluator(gts, ids, spice, meteor)
    assert_same(p.gts, j.gts)
    for caps in (res, {k: gts[k][0] for k in gts}):
        assert_same(_outcome(p.evaluate, caps), _outcome(j.evaluate, caps))
        assert_same(p.eval_scores, j.eval_scores)
        assert_same(p.subgraph_training_bleu, j.subgraph_training_bleu)
