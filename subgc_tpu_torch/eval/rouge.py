"""ROUGE-L (misc/coco-caption/pycocoevalcap/rouge/rouge.py).

The port's own copy of ``subgc_tpu/eval/rouge.py``, held equal to it
by ``tests/test_torch_port_scorers.py``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

BETA = 1.2


def _lcs_len(a: List[str], b: List[str]) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = [0] * (len(b) + 1)
        for j in range(1, len(b) + 1):
            if a[i - 1] == b[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = max(prev[j], cur[j - 1])
        prev = cur
    return prev[len(b)]


def rouge_l_sentence(candidate: str, refs: List[str]) -> float:
    tc = candidate.split(" ")
    prec, rec = [], []
    for ref in refs:
        tr = ref.split(" ")
        lcs = _lcs_len(tr, tc)
        prec.append(lcs / float(len(tc)))
        rec.append(lcs / float(len(tr)))
    pm, rm = max(prec), max(rec)
    if pm != 0 and rm != 0:
        return ((1 + BETA ** 2) * pm * rm) / float(rm + BETA ** 2 * pm)
    return 0.0


def compute_rouge(gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
    assert list(gts.keys()) == list(res.keys())
    scores = [rouge_l_sentence(res[k][0], gts[k]) for k in gts]
    return float(np.mean(scores)), np.asarray(scores)
