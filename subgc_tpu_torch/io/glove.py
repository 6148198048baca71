"""GloVe class-name embeddings (misc/utils.py:348-478); the port's copy of
``subgc_tpu/io/glove.py``'s class-embedding tables.

Builds the [num_names, dim] table fused into graph nodes: per class name,
the GloVe vector, with the reference's typo fixes, multi-word averaging
fallback, and N(0,1) init for unknown tokens.  Reads the plain-text
glove.6B.300d.txt format or the reference's cached torch ``.pt``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

TYPO_FIX = {"brocolli": "broccoli", "sandwhich": "sandwich",
            "kneepad": "knee pad", "skiis": "skis", "tshirt": "shirt"}


def load_glove_txt(path: str, vocab: set) -> Dict[str, np.ndarray]:
    """The vectors of the words in ``vocab`` from a GloVe .txt."""
    table: Dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        for line in f:
            parts = line.rstrip().split(b" ")
            try:
                word = parts[0].decode("utf-8")
            except UnicodeDecodeError:
                continue
            if word in vocab:
                table[word] = np.asarray([float(x) for x in parts[1:]],
                                         np.float32)
    return table


def load_glove_pt(path: str, vocab: set) -> Dict[str, np.ndarray]:
    """The vectors of the words in ``vocab`` from the reference's cached
    torch pickle (glove.6B.300d.pt: a (word->index dict, tensor, size)
    tuple; misc/utils.py:418-422)."""
    import torch

    wv_dict, wv_arr, _ = torch.load(path, map_location="cpu",
                                    weights_only=False)
    arr = wv_arr.numpy()
    return {w: arr[i] for w, i in wv_dict.items() if w in vocab}


def class_embeddings(names: List[str], glove_path: str, dim: int = 300,
                     seed: int = 0) -> np.ndarray:
    """[len(names), dim] embedding table (obj_edge_vectors semantics)."""
    wanted = set()
    fixed_names = []
    for name in names:
        name = TYPO_FIX.get(str(name), str(name))
        fixed_names.append(name)
        wanted.update(name.split(" "))
    if glove_path.endswith(".pt"):
        table = load_glove_pt(glove_path, wanted)
    else:
        table = load_glove_txt(glove_path, wanted)

    rng = np.random.RandomState(seed)
    out = rng.normal(0, 1, (len(names), dim)).astype(np.float32)
    for i, name in enumerate(fixed_names):
        if name in table:
            out[i] = table[name]
            continue
        parts = [table[t] for t in name.split(" ") if t in table]
        if parts:
            out[i] = np.mean(parts, axis=0)
        else:
            print(f"GloVe: no vector for {name!r}")
    return out
