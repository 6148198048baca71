"""The scorer entry points of ``subgc_tpu/ops/native.py``.

``ptb_tokenize_batch``, ``pairwise_cider_matrix`` and ``mutual_bleu4`` run
the host library's C++ cores (``ops/native.py``, built from the source the
JAX package binds, so their results are bitwise equal to its defaults).
The ``*_plain`` functions are the Python paths, the plain versions the
tests hold the cores to (rtol 1e-10, ``tests/test_torch_port_native.py``);
nothing chooses them but a caller that names them.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..ops import native
from .bleu import compute_bleu
from .cider import PairwiseCider
from .tokenizer import tokenize


def ptb_tokenize_batch(sentences: Sequence[str],
                       lowercase: bool = True) -> List[str]:
    """Tokenize a batch of raw sentences -> cleaned token strings."""
    return native.ptb_tokenize_batch(sentences, lowercase)


def pairwise_cider_matrix(df_docs: Sequence[Sequence[str]],
                          hyps: Sequence[str], refs: Sequence[str],
                          sigma: float = 6.0) -> np.ndarray:
    """[len(hyps), len(refs)] pairwise CIDEr sims under a df corpus."""
    return native.pairwise_cider_matrix(df_docs, hyps, refs, sigma)


def mutual_bleu4(sentences: Sequence[str]) -> np.ndarray:
    """BLEU-4 of each sentence vs the others (mBLEU-4 inner loop)."""
    return native.mutual_bleu4(sentences)


def ptb_tokenize_batch_plain(sentences: Sequence[str],
                             lowercase: bool = True) -> List[str]:
    """The Python path of :func:`ptb_tokenize_batch`.  As in the JAX
    package's, the tokenizer always lowercases and ``lowercase`` only keeps
    the C core's signature."""
    return tokenize({0: [{"caption": s} for s in sentences]})[0]


def pairwise_cider_matrix_plain(df_docs: Sequence[Sequence[str]],
                                hyps: Sequence[str], refs: Sequence[str],
                                sigma: float = 6.0) -> np.ndarray:
    """The Python path of :func:`pairwise_cider_matrix`."""
    pc = PairwiseCider(df_docs, sigma=sigma)
    hv = [pc.vec(h) for h in hyps]
    rv = [pc.vec(r) for r in refs]
    return np.asarray([[pc.sim(h, r) for r in rv] for h in hv])


def mutual_bleu4_plain(sentences: Sequence[str]) -> np.ndarray:
    """The Python path of :func:`mutual_bleu4`."""
    out = []
    for i, s in enumerate(sentences):
        gts = {0: [g for j, g in enumerate(sentences) if j != i]}
        corpus, _, _ = compute_bleu(gts, {0: [s]})
        out.append(corpus[3])
    return np.asarray(out)
