"""Seeded test traffic: scene graphs of detections and relations, and each
image's bank of sampled sub-graphs.

The bank is a frozen copy of ``subgc_tpu_torch/data/subgraph_sampler.py::
sample_subgraph_bank`` (the paper's recipe, arXiv:2007.11731 §3.1: five
GT-noun sub-graphs, then sub-graphs grown from one or two seed nodes over
one or two hops of the relation graph, kept with probability 0.7 per
frontier node, de-duplicated by node set).  It draws the same numbers from
the same ``RandomState`` in the same order, so that it returns the same
node sets for a seed; its frontier is found with numpy instead of a Python
loop over the relations, and it keeps only what the test path reads: the
node and relation masks.  ``portbench/tests`` holds it equal to the
original.
"""
from __future__ import annotations

from typing import List

import numpy as np


def _expand(nodes, rel, hops, rng, keep_prob, n_max):
    nodes = set(int(x) for x in nodes)
    for _ in range(hops):
        member = np.zeros(n_max, bool)
        member[list(nodes)] = True
        ina, inb = member[rel[:, 0]], member[rel[:, 1]]
        sel = ina ^ inb
        frontier = set()
        # the original's insertion order, so that the set iterates alike
        for f in np.where(ina, rel[:, 1], rel[:, 0])[sel].tolist():
            frontier.add(f)
        draws = rng.rand(len(frontier))
        for f, u in zip(frontier, draws):
            if u < keep_prob:
                nodes.add(f)
    return nodes


def sample_bank(n_nodes: int, rel_ind: np.ndarray,
                sentence_noun_nodes: List[np.ndarray], n_samples: int,
                seed: int):
    """One image's bank: a list of node sets (5 GT-noun sub-graphs first)
    over ``n_nodes`` detections with relations ``rel_ind`` [K, 2]."""
    rng = np.random.RandomState(seed)
    rel = np.asarray(rel_ind, np.int64)
    n_max = max(n_nodes, int(rel.max()) + 1 if rel.size else 0)
    sets = []
    for nn in sentence_noun_nodes:
        base = set(int(x) for x in nn) if len(nn) else {0}
        sets.append(_expand(base, rel, 1, rng, 1.0, n_max))
    seen = set()
    tries = 0
    while len(sets) - 5 < n_samples and tries < n_samples * 20:
        tries += 1
        k = rng.randint(1, 3)
        seeds = rng.choice(n_nodes, size=min(k, n_nodes), replace=False)
        nodes = _expand(seeds, rel, rng.randint(1, 3), rng, 0.7, n_max)
        key = frozenset(nodes)
        if key in seen or not nodes:
            continue
        seen.add(key)
        sets.append(nodes)
    return sets


def image_seed(seed: int, index: int, stream: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([seed % (1 << 64), index, stream])


def scene_graph(seed: int, index: int, cfg: dict, detections: int,
                relations: int):
    """One image's padded scene graph (the port's ``graph.make_scene_graph``
    layout): ``detections`` regions of uniform [0, 1) features and class
    scores, ``relations`` (subject, object) pairs of distinct regions with
    uniform predicate scores; the dummy node last, zero features and a
    background one-hot; padded relations on the dummy node.  Returns
    (obj_fmap [1, N, F], obj_dist [1, N, C], rel_ind [1, K, 2] int32,
    pred_dist [1, K, P], the relations [relations, 2])."""
    rng = np.random.default_rng(image_seed(seed, index, 0))
    N, K = cfg["obj_num"], cfg["rel_num"]
    n, k = min(detections, N - 1), min(relations, K - 1)
    fmap = np.zeros((1, N, cfg["att_feat_size"]), np.float32)
    fmap[0, :n] = rng.random((n, cfg["att_feat_size"]), np.float32)
    dist = np.zeros((1, N, cfg["num_obj_classes"]), np.float32)
    dist[0, :, 0] = 1.0
    dist[0, :n] = rng.random((n, cfg["num_obj_classes"]), np.float32)
    subj = rng.integers(0, n, k)
    obj = (subj + rng.integers(1, n, k)) % n              # never subj
    rels = np.stack([subj, obj], 1).astype(np.int32)
    rind = np.full((1, K, 2), N - 1, np.int32)
    rind[0, :k] = rels
    pdist = np.zeros((1, K, cfg["num_rel_classes"]), np.float32)
    pdist[0, :, 0] = 1.0
    pdist[0, :k] = rng.random((k, cfg["num_rel_classes"]), np.float32)
    return fmap, dist, rind, pdist, rels


def subgraph_set(seed: int, index: int, cfg: dict, rels: np.ndarray,
                 detections: int, n_samples: int, bucket: int):
    """The test loader's padded sub-graph set of one image
    (``data/dataset.py::EvalLoader.example``): the bank's sampled
    sub-graphs (the 5 GT-noun ones skipped), an even count of them, node
    and relation indices left-packed, padded slots on the dummy node.
    Returns (obj_ind [bucket, N] int32, pred_ind [bucket, K] int32,
    att_mask [bucket, N], valid [bucket], number of real sub-graphs)."""
    N, K = cfg["obj_num"], cfg["rel_num"]
    rng = np.random.default_rng(image_seed(seed, index, 1))
    nouns = [rng.choice(detections, rng.integers(1, 4), replace=False)
             for _ in range(5)]
    bank_seed = int(image_seed(seed, index, 2).generate_state(1)[0])
    sets = sample_bank(detections, rels, nouns, n_samples, bank_seed)[5:]
    S = 2 * (len(sets) // 2)
    if S > bucket:
        raise ValueError(f"{S} sub-graphs exceed the bucket {bucket}")
    obj_ind = np.full((bucket, N), N - 1, np.int32)
    att_mask = np.zeros((bucket, N), np.float32)
    att_mask[:, 0] = 1.0          # padded slots keep the dummy node live
    pred_ind = np.full((bucket, K), K - 1, np.int32)
    valid = np.zeros((bucket,), bool)
    for s, nodes in enumerate(sets[:S]):
        ix = np.sort(np.fromiter(nodes, np.int64))
        obj_ind[s, :len(ix)] = ix
        att_mask[s] = 0.0
        att_mask[s, :len(ix)] = 1.0
        member = np.zeros(N, bool)
        member[ix] = True
        pz = np.nonzero(member[rels[:, 0]] & member[rels[:, 1]])[0]
        pred_ind[s, :len(pz)] = pz
    valid[:S] = True
    return obj_ind, pred_ind, att_mask, valid, S


def test_image(args):
    """One test image of a split, ``args`` = (seed, index, model config,
    mix): (scene graph arrays, sub-graph set arrays, its real sub-graph
    count)."""
    seed, index, cfg, tr = args
    *graph, rels = scene_graph(seed, index, cfg, tr["detections"],
                               tr["relations"])
    subs = subgraph_set(seed, index, cfg, rels, tr["detections"],
                        tr["subgraphs_per_image"], tr["bucket"])
    return graph, subs[:4], subs[4]
