"""Shared n-gram utilities for the scorers (precook of bleu_scorer.py:26-36 /
cider_scorer.py:13-28).

The port's own copy of ``subgc_tpu/eval/ngram.py``, held equal to it
by ``tests/test_torch_port_scorers.py``.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple


def ngram_counts(sentence: str, n: int = 4) -> Dict[tuple, int]:
    words = sentence.split()
    counts: Dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return counts


def max_ref_counts(refs: List[str], n: int = 4) -> Tuple[List[int], Dict]:
    """(per-ref lengths, clipped max n-gram counts) — bleu cook_refs."""
    reflen = []
    maxcounts: Dict[tuple, int] = {}
    for ref in refs:
        words = ref.split()
        reflen.append(len(words))
        for ngram, c in ngram_counts(ref, n).items():
            if c > maxcounts.get(ngram, 0):
                maxcounts[ngram] = c
    return reflen, maxcounts
