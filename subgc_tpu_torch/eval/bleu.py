"""BLEU-1..4 with per-image material for the oracle recompute.

Matches the reference's *modified* vendored scorer
(`misc/coco-caption/pycocoevalcap/bleu/bleu_scorer.py:207-283`): besides
corpus BLEU and per-image BLEU it returns the raw per-image components
(`subgraph_training_bleu`) that `misc/sentence_utils.py:28-53` re-aggregates
to compute corpus BLEU over oracle-selected sentences.

The port's own copy of ``subgc_tpu/eval/bleu.py``, held equal to it
by ``tests/test_torch_port_scorers.py``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

from .ngram import max_ref_counts, ngram_counts

_SMALL = 1e-9
_TINY = 1e-15


def _closest_reflen(reflens: List[int], testlen: int) -> int:
    return min((abs(l - testlen), l) for l in reflens)[1]


def _cook_test(test: str, reflens, refmax, n=4):
    words = test.split()
    testlen = len(words)
    guess = [max(0, testlen - k + 1) for k in range(1, n + 1)]
    correct = [0] * n
    for ngram, count in ngram_counts(test, n).items():
        correct[len(ngram) - 1] += min(refmax.get(ngram, 0), count)
    return testlen, guess, correct


def bleu_from_components(testlen, reflen, guess, correct, n=4):
    """Corpus BLEU from summed components (bleu_scorer.py:265-276).

    Also the helper `sentence_utils.cal_bleu` uses for oracle recompute.
    """
    bleus = []
    bleu = 1.0
    for k in range(n):
        bleu *= (correct[k] + _TINY) / (guess[k] + _SMALL)
        bleus.append(bleu ** (1.0 / (k + 1)))
    ratio = (testlen + _TINY) / (reflen + _SMALL)
    if ratio < 1:
        for k in range(n):
            bleus[k] *= math.exp(1 - 1 / ratio)
    return bleus


def compute_bleu(gts: Dict, res: Dict, n: int = 4,
                 option: str = "closest") -> Tuple[List[float], List[List[float]], dict]:
    """(corpus [B1..B4], per-image [4][imgs], per-image components).

    gts/res: {img_id: [tokenized strings]} with len(res[id]) == 1, iterated
    in gts key order (Bleu.compute_score semantics).
    """
    assert list(gts.keys()) == list(res.keys())
    per_image = [[] for _ in range(n)]
    material = {"testlen": [], "reflen": [], "guess": [[] for _ in range(n)],
                "correct": [[] for _ in range(n)]}
    tot_testlen = 0
    tot_reflen = 0.0
    tot_guess = [0] * n
    tot_correct = [0] * n

    for img_id in gts:
        refs = gts[img_id]
        hypo = res[img_id]
        assert len(hypo) == 1
        reflens, refmax = max_ref_counts(refs, n)
        testlen, guess, correct = _cook_test(hypo[0], reflens, refmax, n)
        if option == "closest":
            reflen = _closest_reflen(reflens, testlen)
        elif option == "average":
            reflen = sum(reflens) / len(reflens)
        elif option == "shortest":
            reflen = min(reflens)
        else:
            raise ValueError(option)

        tot_testlen += testlen
        tot_reflen += reflen
        material["testlen"].append(testlen)
        material["reflen"].append(reflen)
        bleu = 1.0
        for k in range(n):
            tot_guess[k] += guess[k]
            tot_correct[k] += correct[k]
            material["guess"][k].append(guess[k])
            material["correct"][k].append(correct[k])
            bleu *= (correct[k] + _TINY) / (guess[k] + _SMALL)
            per_image[k].append(bleu ** (1.0 / (k + 1)))
        ratio = (testlen + _TINY) / (reflen + _SMALL)
        if ratio < 1:
            for k in range(n):
                per_image[k][-1] *= math.exp(1 - 1 / ratio)

    corpus = bleu_from_components(tot_testlen, tot_reflen, tot_guess,
                                  tot_correct, n)
    return corpus, per_image, material
