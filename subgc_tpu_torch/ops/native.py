"""ctypes binding to the host library's C++ cores (``native/subgc_native.cpp``).

The counterpart of ``subgc_tpu/ops/native.py``: the PTB tokenizer, the
pairwise-CIDEr matrix, mutual BLEU-4 and the positive/negative sub-graph
sampler of the train loader, from the same source, so the two packages'
results are bitwise equal.  The library is built at first use by
``ops/_build.py`` (``g++ -O2 -fPIC -shared -std=c++17`` into the port's
build directory).  Where the JAX package prints and falls back to Python
when the build fails, here a failed build or load raises.  The Python paths
are the plain versions: ``eval/pairwise.py``'s ``*_plain`` functions and
``data/dataset.py::sample_pos_neg``, which callers choose by name (or, for
the sampler, with ``native_sampler=False`` / ``SUBGC_NATIVE_SAMPLER=0``).
"""
from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence

import numpy as np

from . import _build

_lib = None
_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded library with every entry point's signature set; built on
    first use.  Raises when the build or the load fails."""
    global _lib
    with _lock:
        if _lib is None:
            lib = _build.load_host("subgc_native")
            lib.subgc_ptb_tokenize.restype = ctypes.c_void_p
            lib.subgc_ptb_tokenize.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.subgc_free.restype = None
            lib.subgc_free.argtypes = [ctypes.c_void_p]
            lib.subgc_pairwise_cider.restype = ctypes.c_int
            lib.subgc_pairwise_cider.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_double, ctypes.POINTER(ctypes.c_double)]
            lib.subgc_mutual_bleu4.restype = ctypes.c_int
            lib.subgc_mutual_bleu4.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_double)]
            lib.subgc_sample_pos_neg.restype = ctypes.c_int
            lib.subgc_sample_pos_neg.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_double, ctypes.c_int,
                ctypes.c_ulonglong, ctypes.POINTER(ctypes.c_longlong)]
            _lib = lib
        return _lib


def _oneline(s: str) -> str:
    """Collapse whitespace separators embedded in a sentence before it
    rides the '\\n'/'\\t'-framed blobs.  An embedded newline would desync
    the C side's line count from the output buffer allocated here (a heap
    overflow); an embedded tab would split a df document in the wrong place
    or, since the C tokenizer splits on ' ' only where Python's
    ``str.split()`` splits on any whitespace, fuse two tokens.  Collapsing
    to spaces leaves the Python paths' results unchanged."""
    return s.replace("\n", " ").replace("\r", " ").replace("\t", " ")


def _doubles(out: np.ndarray):
    return out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def ptb_tokenize_batch(sentences: Sequence[str],
                       lowercase: bool = True) -> List[str]:
    """Tokenize a batch of raw sentences -> cleaned token strings."""
    lib = library()
    blob = "\n".join(_oneline(s) for s in sentences)
    ptr = lib.subgc_ptb_tokenize(blob.encode("utf-8"), 1 if lowercase else 0)
    try:
        result = ctypes.string_at(ptr).decode("utf-8")
    finally:
        lib.subgc_free(ptr)
    return result.split("\n")


def pairwise_cider_matrix(df_docs: Sequence[Sequence[str]],
                          hyps: Sequence[str], refs: Sequence[str],
                          sigma: float = 6.0) -> np.ndarray:
    """[len(hyps), len(refs)] pairwise CIDEr sims under a df corpus."""
    df_blob = "\n".join("\t".join(_oneline(s) for s in doc)
                        for doc in df_docs)
    out = np.zeros((len(hyps), len(refs)), np.float64)
    rc = library().subgc_pairwise_cider(
        df_blob.encode("utf-8"),
        "\n".join(_oneline(h) for h in hyps).encode("utf-8"),
        "\n".join(_oneline(r) for r in refs).encode("utf-8"), sigma,
        _doubles(out))
    if rc != 0:
        raise RuntimeError(f"subgc_pairwise_cider returned {rc}")
    return out


def mutual_bleu4(sentences: Sequence[str]) -> np.ndarray:
    """BLEU-4 of each sentence vs the others (mBLEU-4 inner loop)."""
    out = np.zeros((len(sentences),), np.float64)
    rc = library().subgc_mutual_bleu4(
        "\n".join(_oneline(s) for s in sentences).encode("utf-8"),
        _doubles(out))
    if rc != 0:
        raise RuntimeError(f"subgc_mutual_bleu4 returned {rc}")
    return out


def sample_pos_neg_native(node_iou_mtx: np.ndarray, thres: float, half: int,
                          seq_per_img: int, seed: int) -> Optional[np.ndarray]:
    """The C++ weighted positive/negative sub-graph sampler: the branches
    and weights of ``data/dataset.py::sample_pos_neg``, its draws from a
    mt19937_64 seeded by ``seed``.  Returns [seq_per_img, half, 2] int64
    indices, or None where the C++ sampler declines the matrix (fewer rows
    than ``seq_per_img``, no sampled column, or no negative pool): the
    JAX package's contract, whose callers then run the Python sampler."""
    if node_iou_mtx.ndim != 2 or node_iou_mtx.shape[0] < seq_per_img:
        return None
    # all rows: the weights' column sums cover the whole matrix, also when
    # only the first seq_per_img rows are sampled
    m = np.ascontiguousarray(node_iou_mtx, np.float32)
    out = np.empty((seq_per_img, half, 2), np.int64)
    rc = library().subgc_sample_pos_neg(
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        m.shape[0], seq_per_img, m.shape[1], float(thres), half,
        ctypes.c_ulonglong(int(seed) & 0xFFFFFFFFFFFFFFFF),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)))
    return out if rc == 0 else None
