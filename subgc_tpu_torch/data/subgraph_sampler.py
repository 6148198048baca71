"""Offline sub-graph bank generation (the *_graph_mask_1000_rm_duplicate npz);
the port's own copy of ``subgc_tpu/data/subgraph_sampler.py`` (numpy only,
held bit-identical to it for the same seed by
``tests/test_torch_port_subgraph_sampler.py``).  ``cli/serve.py`` samples a
bank on the fly for a request that brings no sub-graphs.

The reference downloads this artifact precomputed (`data/README.md`: "store
the sampled sub-graphs") — the generator itself is not in the repo.  This
module reconstructs it following the paper's recipe (arXiv:2007.11731 §3.1):

* sample sub-graphs by picking seed nodes and expanding to neighbors over
  the relation graph, de-duplicated by node set ("rm_duplicate"),
* prepend 5 GT-noun sub-graphs (nodes whose detected class matches a GT
  caption noun, plus their neighbor closure),
* store per-sub-graph object/predicate masks, re-indexed relation indices
  and seed nodes, plus the [5, 5+S] node-IoU matrix of every sub-graph
  against every sentence's noun node set.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence, Set

import numpy as np

from ..io.sg_npz import write_feat_npz
from ..utils.lemma import lemmatize


def nouns_to_nodes(caption_words: Sequence[str], node_classes: Sequence[str]
                   ) -> np.ndarray:
    """Nodes whose detected class name matches a caption word (lemma match)."""
    lemmas = {lemmatize(w) for w in caption_words}
    hits = [i for i, cls in enumerate(node_classes)
            if lemmatize(str(cls)) in lemmas
            or any(lemmatize(p) in lemmas for p in str(cls).split(" "))]
    return np.asarray(hits, np.int64)


def _mask_entry(nodes: Set[int], rel_ind: np.ndarray, seeds: np.ndarray,
                max_obj: int, max_rel: int):
    obj_mask = np.zeros(max_obj, np.int64)
    obj_mask[list(nodes)] = 1
    in_sub = np.isin(rel_ind[:, 0], list(nodes)) \
        & np.isin(rel_ind[:, 1], list(nodes))
    pred_mask = np.zeros(max_rel, np.int64)
    pred_mask[:rel_ind.shape[0]][in_sub] = 1
    order = np.sort(np.asarray(list(nodes)))
    remap = {int(v): j for j, v in enumerate(order)}
    nrel = np.asarray([[remap[int(a)], remap[int(b)]]
                       for a, b in rel_ind[in_sub]], np.int64).reshape(-1, 2)
    return [None, obj_mask, pred_mask, nrel, np.asarray(seeds, np.int64)]


def _expand(seed: Set[int], rel_ind: np.ndarray, hops: int,
            rng: np.random.RandomState, keep_prob: float = 1.0) -> Set[int]:
    nodes = set(int(x) for x in seed)
    for _ in range(hops):
        frontier = set()
        for a, b in rel_ind:
            a, b = int(a), int(b)
            if a in nodes and b not in nodes:
                frontier.add(b)
            if b in nodes and a not in nodes:
                frontier.add(a)
        for f in frontier:
            if rng.rand() < keep_prob:
                nodes.add(f)
    return nodes


def node_iou(a: Set[int], b: Set[int]) -> float:
    if not a or not b:
        return 0.0
    return len(a & b) / float(len(a | b))


def sample_subgraph_bank(n_nodes: int, rel_ind: np.ndarray,
                         sentence_noun_nodes: List[np.ndarray],
                         n_samples: int = 1000, max_obj: int = 36,
                         max_rel: int = 64, seed: int = 0) -> Dict:
    """Build one image's mask-bank dict ('feat' payload of the npz).

    sentence_noun_nodes: per GT sentence (5), the matched node index array.
    """
    rng = np.random.RandomState(seed)
    rel_ind = np.asarray(rel_ind, np.int64)

    entries = []
    node_sets: List[Set[int]] = []

    # 5 GT-noun sub-graphs first (neighbor closure over the noun nodes)
    gt_sets = []
    for nn in sentence_noun_nodes:
        base = set(int(x) for x in nn) if len(nn) else {0}
        nodes = _expand(base, rel_ind, hops=1, rng=rng)
        gt_sets.append(set(int(x) for x in nn))
        entries.append(_mask_entry(nodes, rel_ind, np.asarray(sorted(base)),
                                   max_obj, max_rel))
        node_sets.append(nodes)

    # sampled sub-graphs: random seed pair + stochastic expansion, dedup
    seen: Set[frozenset] = set()
    tries = 0
    while len(entries) - 5 < n_samples and tries < n_samples * 20:
        tries += 1
        k = rng.randint(1, 3)
        seeds = rng.choice(n_nodes, size=min(k, n_nodes), replace=False)
        nodes = _expand(set(int(x) for x in seeds), rel_ind,
                        hops=rng.randint(1, 3), rng=rng, keep_prob=0.7)
        key = frozenset(nodes)
        if key in seen or not nodes:
            continue
        seen.add(key)
        entries.append(_mask_entry(nodes, rel_ind, seeds, max_obj, max_rel))
        node_sets.append(nodes)

    total = len(entries)
    iou_mtx = np.zeros((len(sentence_noun_nodes), total), np.float32)
    for si, nn in enumerate(sentence_noun_nodes):
        sset = set(int(x) for x in nn)
        for gi, nodes in enumerate(node_sets):
            iou_mtx[si, gi] = node_iou(sset, nodes)

    return {"node_iou_mtx": iou_mtx, "subgraph_mask_list": entries}


def export_bank(out_dir: str, img_id, bank: Dict) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{img_id}.npz")
    write_feat_npz(path, bank)
    return path
