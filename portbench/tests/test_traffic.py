"""Seeded traffic: the same seed gives the same banks and batches, a bank
holds 1,000 de-duplicated sub-graphs, and the frozen sampler draws what the
port's own sampler draws."""
from __future__ import annotations

import numpy as np
import pytest

from conftest import load, small_config
from portbench.traffic import sampler
from portbench.traffic.train_batch import train_batch

BIG = 2 ** 33 + 5          # seeds run past 32 bits


def test_bank_of_a_published_scene_graph_holds_1000_distinct_subgraphs():
    cfg = load("portbench", "configs", "sub_gc.json")
    tr = load("portbench", "traffic", "kar_test.json")
    graph, subs, n = sampler.test_image((BIG, 3, cfg, tr))
    obj_ind, pred_ind, att_mask, valid = subs
    assert n == tr["subgraphs_per_image"] == 1000
    assert valid.sum() == n and not valid[n:].any()
    sets = {frozenset(obj_ind[s, :int(att_mask[s].sum())].tolist())
            for s in range(n)}
    assert len(sets) == n
    assert all(max(s) < tr["detections"] for s in sets)
    assert graph[0].shape == (1, cfg["obj_num"], cfg["att_feat_size"])
    rel = graph[2][0]
    real = rel[:tr["relations"]]
    assert (real[:, 0] != real[:, 1]).all()
    assert (rel[tr["relations"]:] == cfg["obj_num"] - 1).all()


def test_same_seed_same_test_images_other_seed_others():
    cfg = small_config("sub_gc.kar_test")
    tr = dict(detections=10, relations=16, subgraphs_per_image=40, bucket=64)
    a = sampler.test_image((BIG, 1, cfg, tr))
    b = sampler.test_image((BIG, 1, cfg, tr))
    c = sampler.test_image((BIG + 1, 1, cfg, tr))
    for x, y in zip(a[0] + list(a[1]), b[0] + list(b[1])):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0][0], c[0][0])
    assert not np.array_equal(a[1][0], c[1][0])


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11])
def test_frozen_sampler_draws_what_the_port_draws(seed):
    from subgc_tpu_torch.data.subgraph_sampler import sample_subgraph_bank
    rng = np.random.RandomState(seed % 2 ** 32)
    rel = rng.randint(0, 20, (30, 2))
    nouns = [rng.choice(20, rng.randint(0, 4), replace=False)
             for _ in range(5)]
    seed32 = seed % 2 ** 32
    port = sample_subgraph_bank(20, rel, nouns, n_samples=200, seed=seed32)
    ours = sampler.sample_bank(20, rel, nouns, 200, seed32)
    assert len(ours) == len(port["subgraph_mask_list"])
    for entry, nodes in zip(port["subgraph_mask_list"], ours):
        assert set(np.nonzero(entry[1])[0].tolist()) == nodes


def test_same_seed_same_train_batch():
    cfg = small_config("sub_gc.kar_train")
    a = train_batch(BIG, 2, cfg, 3, 5, 2)
    b = train_batch(BIG, 2, cfg, 3, 5, 2)
    c = train_batch(BIG, 3, cfg, 3, 5, 2)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["labels"], c["labels"])
    S, N = 15, cfg["obj_num"]
    assert a["labels"].shape == (S, cfg["seq_length"] + 2)
    assert a["sub_obj_ind"].shape == (S, 2, 2, N)
    sizes = a["sub_att_mask"].sum(-1)
    assert sizes.min() >= 3 and sizes.max() <= 8
    for s, m in zip(a["sub_obj_ind"].reshape(-1, N),
                    a["sub_att_mask"].reshape(-1, N)):
        nodes = s[m > 0]
        assert len(set(nodes.tolist())) == len(nodes) and nodes.max() < N - 1
