"""Diversity metrics over the captions_*.npy artifact.

Reimplements `misc/diversity/diversity_score.py:55-163` without the Java
tokenizer: distinct-caption ratio, novel-vs-train count, 1/2-gram diversity,
and mBLEU-4 of the best-5 (by sGPN score) out of random-20/random-100
selections per image (np seed 2019, matching the reference).

The port's own copy of ``subgc_tpu/eval/diversity.py``, held equal to it
by ``tests/test_torch_port_metrics.py``.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .pairwise import mutual_bleu4
from .tokenizer import tokenize


def _select_best5(item: dict, top_k: int, rng: np.random.RandomState):
    """Random top_k then best-5 by sGPN (diversity_score.py:62-66)."""
    sub_num = len(item["caption"])
    rand_ind = rng.choice(sub_num, min(top_k, sub_num), replace=False)
    selected_gpn = np.asarray(item["subgraph_score"])[rand_ind]
    best5 = rand_ind[np.argsort(selected_gpn)[::-1][:5]]
    return [item["caption"][i] for i in best5], rand_ind


def distinct_ratio(predictions: List[dict], top_ns=(20, 100),
                   seed: int = 2019, rng=None) -> List[float]:
    """Mean per-image fraction of unique captions among random top_n."""
    rng = np.random.RandomState(seed) if rng is None else rng
    out = np.zeros((len(top_ns), len(predictions)))
    for i, item in enumerate(predictions):
        sub_num = len(item["caption"])
        for t, top_k in enumerate(top_ns):
            rand_ind = rng.choice(sub_num, min(top_k, sub_num), replace=False)
            sents = [item["caption"][j] for j in rand_ind]
            out[t, i] = len(set(sents)) / float(len(sents))
    return [float(x) for x in out.mean(1)]


def novel_count(predictions: List[dict], train_sentences: Sequence[str],
                top_ns=(20, 100), seed: int = 2019, rng=None) -> List[int]:
    """Count of best-5 captions not present in the train corpus
    (diversity_score.py:115-144; train sentences lowercased, periods
    stripped)."""
    train = set(s.lower().replace(".", "") for s in train_sentences)
    rng = np.random.RandomState(seed) if rng is None else rng
    counts = [0] * len(top_ns)
    for item in predictions:
        for t, top_k in enumerate(top_ns):
            sents, _ = _select_best5(item, top_k, rng)
            counts[t] += sum(1 for s in sents if s not in train)
    return counts


def ngram_diversity(predictions: List[dict], top_ns=(20, 100),
                    seed: int = 2019, rng=None) -> np.ndarray:
    """[len(top_ns), 2] distinct 1-/2-gram ratios of best-5 sets
    (diversity_score.py:86-112: both normalized by total word count)."""
    rng = np.random.RandomState(seed) if rng is None else rng
    out = np.zeros((len(top_ns), 2, len(predictions)))
    for i, item in enumerate(predictions):
        for t, top_k in enumerate(top_ns):
            sents, _ = _select_best5(item, top_k, rng)
            split = [s.split(" ") for s in sents]
            words = [w for s in split for w in s]
            bigrams = [(s[j], s[j + 1]) for s in split
                       for j in range(len(s) - 1)]
            total = float(len(words))
            out[t, 0, i] = len(set(words)) / total
            out[t, 1, i] = len(set(bigrams)) / total
    return out.mean(2)


def mbleu4(predictions: List[dict], top_ns=(20, 100),
           seed: int = 2019, rng=None) -> List[float]:
    """Mutual BLEU-4: each best-5 caption scored against the other 4
    (diversity_score.py:57-84).  Lower = more diverse.

    Loop nesting matches the reference (images outer, top_ns inner, one
    shared RNG stream)."""
    rng = np.random.RandomState(seed) if rng is None else rng
    per_img = [[] for _ in top_ns]
    for item in predictions:
        for t, top_k in enumerate(top_ns):
            sents, _ = _select_best5(item, top_k, rng)
            tokenized = tokenize({0: [{"caption": s} for s in sents]})[0]
            scores = mutual_bleu4(tokenized)
            per_img[t].append(float(np.mean(scores)))
    return [float(np.mean(x)) for x in per_img]


def diversity_report(predictions: List[dict],
                     train_sentences: Sequence[str] = (),
                     evaluate_mb4: bool = True, seed: int = 2019) -> dict:
    """All four metrics, consuming ONE RNG stream in the reference's metric
    order — mBLEU4 (if enabled), n-gram, novel, distinct — so every number
    equals the reference script's output byte for byte
    (diversity_score.py:8,20,57-163 runs metrics 4,3,2,1 against a single
    np.random.seed(2019) stream; per-metric fresh streams would select
    different random sub-sets for every metric after the first)."""
    rng = np.random.RandomState(seed)
    report = {}
    if evaluate_mb4:
        report["mBLEU4"] = mbleu4(predictions, rng=rng)
    ng = ngram_diversity(predictions, rng=rng)
    report["ngram"] = {"1gram@20": float(ng[0, 0]), "2gram@20": float(ng[0, 1]),
                       "1gram@100": float(ng[1, 0]), "2gram@100": float(ng[1, 1])}
    if train_sentences:
        report["novel"] = novel_count(predictions, train_sentences, rng=rng)
    report["distinct"] = distinct_ratio(predictions, rng=rng)
    return report
