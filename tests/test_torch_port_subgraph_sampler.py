"""The port's sub-graph bank sampler (``subgc_tpu_torch/data/
subgraph_sampler.py``) held bit-identical to the JAX package's over several
seeds and scene graphs: ``nouns_to_nodes``, ``node_iou``,
``sample_subgraph_bank`` (every mask, re-indexed relation list, seed array
and the node-IoU matrix), and ``export_bank`` written by one package and
read by the other's ``read_feat_npz``.
"""
import numpy as np
import pytest

from subgc_tpu.data import subgraph_sampler as J
from subgc_tpu.io.sg_npz import read_feat_npz as j_read_feat_npz
from subgc_tpu_torch.data import subgraph_sampler as P
from subgc_tpu_torch.io.sg_npz import read_feat_npz


def _graph(seed):
    rng = np.random.RandomState(seed)
    n = rng.randint(3, 37)
    k = rng.randint(1, 65)
    rel_ind = rng.randint(0, n, (k, 2))
    nouns = [rng.choice(n, rng.randint(0, 4), replace=False)
             for _ in range(5)]
    return n, rel_ind, nouns


def _assert_banks_equal(a, b):
    assert sorted(a) == sorted(b) == ["node_iou_mtx", "subgraph_mask_list"]
    np.testing.assert_array_equal(a["node_iou_mtx"], b["node_iou_mtx"])
    assert a["node_iou_mtx"].dtype == b["node_iou_mtx"].dtype
    assert len(a["subgraph_mask_list"]) == len(b["subgraph_mask_list"])
    for x, y in zip(a["subgraph_mask_list"], b["subgraph_mask_list"]):
        assert x[0] is None and y[0] is None
        for u, v in zip(x[1:], y[1:]):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_sample_subgraph_bank_bit_identical(seed):
    n, rel_ind, nouns = _graph(seed)
    for bank_seed, n_samples in ((seed, 30), (seed + 100, 64)):
        got = P.sample_subgraph_bank(n, rel_ind, nouns, n_samples=n_samples,
                                     seed=bank_seed)
        want = J.sample_subgraph_bank(n, rel_ind, nouns, n_samples=n_samples,
                                      seed=bank_seed)
        _assert_banks_equal(got, want)
        assert len(got["subgraph_mask_list"]) >= 6


def test_serving_bank_is_the_jax_servers():
    """The call ``cli/serve.py`` makes for a request without sub-graphs."""
    rng = np.random.RandomState(9)
    for n in (1, 2, 8, 36):
        rel_ind = rng.randint(0, n, (rng.randint(1, 20), 2))
        args = (n, rel_ind, [np.arange(min(2, n))] * 5)
        _assert_banks_equal(P.sample_subgraph_bank(*args, n_samples=64),
                            J.sample_subgraph_bank(*args, n_samples=64))


def test_nouns_to_nodes_and_node_iou_equal_jax():
    classes = ["man", "dogs", "tennis racket", "shirt", "women", "bus",
               "glasses", "leaves", "running shoe"]
    for words in (["a", "man", "walking", "his", "dog"],
                  ["two", "woman", "hold", "rackets"],
                  ["buses", "on", "the", "street"], ["leaf", "shoes"], []):
        got = P.nouns_to_nodes(words, classes)
        want = J.nouns_to_nodes(words, classes)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for a, b in (({1, 2}, {2, 3}), (set(), {1}), ({4}, {4}), ({1}, {2})):
        assert P.node_iou(a, b) == J.node_iou(a, b)


def test_export_bank_round_trips_both_ways(tmp_path):
    n, rel_ind, nouns = _graph(11)
    bank = P.sample_subgraph_bank(n, rel_ind, nouns, n_samples=20, seed=3)
    path = P.export_bank(str(tmp_path / "port"), 123, bank)
    assert path.endswith("123.npz")
    _assert_banks_equal(read_feat_npz(path), bank)
    _assert_banks_equal(j_read_feat_npz(path), bank)
    jpath = J.export_bank(str(tmp_path / "jax"), 123, bank)
    _assert_banks_equal(read_feat_npz(jpath), bank)
