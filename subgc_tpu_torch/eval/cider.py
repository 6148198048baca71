"""CIDEr (+ the pairwise-vs-one-reference variant used by consensus
reranking).

Matches `misc/coco-caption/pycocoevalcap/cider/cider_scorer.py`: TF-IDF
n-gram vectors with doc-freq over the reference *corpus*, clipped cosine
similarity per n, length gaussian penalty (sigma 6), mean over n, /len(refs),
x10.

The pairwise variant reproduces `misc/consensus_reranking/external/
coco-caption/pycocoevalcap/cider/cider_scorer_compute_sentence.py`: score one
hypothesis against ONE reference sentence at a time under a fixed
document-frequency table (built from the train corpus).

The port's own copy of ``subgc_tpu/eval/cider.py``, held equal to it
by ``tests/test_torch_port_scorers.py``.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, Sequence, Tuple

import numpy as np

from .ngram import ngram_counts


def compute_doc_freq(crefs: Sequence[Sequence[Dict]]) -> Dict:
    """Document frequency over images (cider_scorer.py:94-102).

    crefs: per image, list of per-ref n-gram count dicts."""
    df: Dict[tuple, float] = defaultdict(float)
    for refs in crefs:
        for ngram in set(ng for ref in refs for ng in ref):
            df[ngram] += 1
    return df


def _counts2vec(cnts, df, ref_len, n=4):
    vec = [defaultdict(float) for _ in range(n)]
    length = 0
    norm = [0.0] * n
    for ngram, tf in cnts.items():
        dfv = math.log(max(1.0, df.get(ngram, 0.0)))
        k = len(ngram) - 1
        vec[k][ngram] = float(tf) * (ref_len - dfv)
        norm[k] += vec[k][ngram] ** 2
        if k == 1:
            length += tf
    return vec, [math.sqrt(x) for x in norm], length


def _sim(vh, vr, nh, nr, lh, lr, n=4, sigma=6.0):
    delta = float(lh - lr)
    val = np.zeros(n)
    for k in range(n):
        for ngram in vh[k]:
            val[k] += min(vh[k][ngram], vr[k][ngram]) * vr[k][ngram]
        if nh[k] != 0 and nr[k] != 0:
            val[k] /= nh[k] * nr[k]
        val[k] *= math.e ** (-(delta ** 2) / (2 * sigma ** 2))
    return val


def compute_cider(gts: Dict, res: Dict, n: int = 4,
                  sigma: float = 6.0) -> Tuple[float, np.ndarray]:
    """(mean CIDEr, per-image scores) in gts key order."""
    assert list(gts.keys()) == list(res.keys())
    crefs = [[ngram_counts(r, n) for r in gts[k]] for k in gts]
    ctest = [ngram_counts(res[k][0], n) for k in res]
    df = compute_doc_freq(crefs)
    ref_len = np.log(float(len(crefs)))

    scores = []
    for test, refs in zip(ctest, crefs):
        vec, norm, length = _counts2vec(test, df, ref_len, n)
        score = np.zeros(n)
        for ref in refs:
            vr, nr, lr = _counts2vec(ref, df, ref_len, n)
            score += _sim(vec, vr, norm, nr, length, lr, n, sigma)
        scores.append(float(score.mean() / len(refs) * 10.0))
    return float(np.mean(scores)), np.asarray(scores)


class PairwiseCider:
    """Pairwise hypothesis-vs-single-reference CIDEr under a fixed train-
    corpus document-frequency table (consensus reranking's scorer).

    ``ref_len`` is log(#documents in the df corpus), as in the external
    cider_scorer_compute_sentence.py.
    """

    def __init__(self, train_refs: Sequence[Sequence[str]], n: int = 4,
                 sigma: float = 6.0):
        self.n = n
        self.sigma = sigma
        crefs = [[ngram_counts(r, n) for r in refs] for refs in train_refs]
        self.df = compute_doc_freq(crefs)
        self.ref_len = np.log(float(len(crefs)))

    def vec(self, sentence: str):
        return _counts2vec(ngram_counts(sentence, self.n), self.df,
                           self.ref_len, self.n)

    def sim(self, hyp_vec, ref_vec) -> float:
        vh, nh, lh = hyp_vec
        vr, nr, lr = ref_vec
        val = _sim(vh, vr, nh, nr, lh, lr, self.n, self.sigma)
        return float(val.mean() * 10.0)

    def score(self, hypothesis: str, reference: str) -> float:
        return self.sim(self.vec(hypothesis), self.vec(reference))
