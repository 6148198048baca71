"""The scorer entry points of ``subgc_tpu/ops/native.py``, in Python.

The JAX package binds three host cores of ``native/subgc_native.cpp``
through ctypes and falls back to these Python paths when the library is
missing.  The port has no C++ host library yet, so it runs the Python paths
always; their results equal the C++ cores' to rtol 1e-10
(``tests/test_torch_port_metrics.py``).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .bleu import compute_bleu
from .cider import PairwiseCider
from .tokenizer import tokenize


def ptb_tokenize_batch(sentences: Sequence[str],
                       lowercase: bool = True) -> List[str]:
    """Tokenize a batch of raw sentences -> cleaned token strings.  As in
    the JAX package's Python path, the tokenizer always lowercases and
    ``lowercase`` only keeps the C core's signature."""
    return tokenize({0: [{"caption": s} for s in sentences]})[0]


def pairwise_cider_matrix(df_docs: Sequence[Sequence[str]],
                          hyps: Sequence[str], refs: Sequence[str],
                          sigma: float = 6.0) -> np.ndarray:
    """[len(hyps), len(refs)] pairwise CIDEr sims under a df corpus."""
    pc = PairwiseCider(df_docs, sigma=sigma)
    hv = [pc.vec(h) for h in hyps]
    rv = [pc.vec(r) for r in refs]
    return np.asarray([[pc.sim(h, r) for r in rv] for h in hv])


def mutual_bleu4(sentences: Sequence[str]) -> np.ndarray:
    """BLEU-4 of each sentence vs the others (mBLEU-4 inner loop)."""
    out = []
    for i, s in enumerate(sentences):
        gts = {0: [g for j, g in enumerate(sentences) if j != i]}
        corpus, _, _ = compute_bleu(gts, {0: [s]})
        out.append(corpus[3])
    return np.asarray(out)
