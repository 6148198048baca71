"""The port's ``parallel/mesh.py`` and ``parallel/distributed.py`` on the
CPU: the host slicing rules equal the JAX package's on the same numpy
trees (exactly); ``maybe_initialize_distributed`` is a no-op with nothing
set and joins a one-rank gloo group from ``SUBGC_COORDINATOR`` +
``SUBGC_NUM_PROCESSES=1`` + ``SUBGC_PROCESS_ID=0``, where the collectives
the train step uses run; the mesh's replicate / shard / gather round trips
are exact; a data-parallel rank's draws are its rows of the global draw,
bitwise; ``steps.one_ulp_away`` moves every element by exactly one ulp.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from subgc_tpu.parallel import distributed as JD
from subgc_tpu_torch.config import ModelConfig
from subgc_tpu_torch.data.synthetic import synthetic_train_batch
from subgc_tpu_torch.graph import SceneGraph
from subgc_tpu_torch.parallel import distributed as D
from subgc_tpu_torch.parallel import launch
from subgc_tpu_torch.parallel import mesh as M
from subgc_tpu_torch.parallel import steps as PS
from subgc_tpu_torch.train.step import local_train_batch

TINY = ModelConfig(vocab_size=20, rnn_size=16, input_encoding_size=16,
                   att_hid_size=8, gcn_dim=8, fc_feat_size=16,
                   att_feat_size=16, embed_dim=8, num_obj_classes=12,
                   num_rel_classes=6)
ENV = ("SUBGC_COORDINATOR", "SUBGC_NUM_PROCESSES", "SUBGC_PROCESS_ID",
       "SUBGC_AUTO_DISTRIBUTED")


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


@pytest.mark.parametrize("pc", [1, 2, 4])
def test_slicing_rules_equal_jax(pc):
    batch = synthetic_train_batch(TINY, 8, seed=1)
    for pi in range(pc):
        got = D.slice_local_shards(batch, pi, pc)
        want = JD.slice_local_shards(batch, pi, pc)
        for g, w in zip(_leaves(got), _leaves(want), strict=True):
            np.testing.assert_array_equal(g, w)
        per = 8 // pc
        assert D.local_batch_slice(8, pi, pc) == slice(pi * per,
                                                       (pi + 1) * per)
    # with no group: one process, the whole batch (JAX: process_count 1)
    assert D.local_batch_slice(8) == JD.local_batch_slice(8)
    assert D.slice_local_shards(batch) is batch


def test_local_train_batch_rebases_img_ix():
    batch = synthetic_train_batch(TINY, 4, seed=2)
    local = local_train_batch(batch, 1, 2)
    np.testing.assert_array_equal(local.img_ix, np.repeat([0, 1], 5))
    np.testing.assert_array_equal(local.graph.obj_fmap,
                                  batch.graph.obj_fmap[2:])
    np.testing.assert_array_equal(local.labels, batch.labels[10:])
    assert local_train_batch(batch, 0, 1) is batch


def test_maybe_initialize_distributed_is_a_noop_unset(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    assert D.maybe_initialize_distributed() is False
    assert not dist.is_initialized()
    assert (D.get_process_index(), D.get_process_count()) == (0, 1)
    assert D.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("SUBGC_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="go together"):
        D.maybe_initialize_distributed()


def test_one_rank_group_from_the_environment(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SUBGC_COORDINATOR",
                       f"127.0.0.1:{launch.free_port()}")
    monkeypatch.setenv("SUBGC_NUM_PROCESSES", "1")
    monkeypatch.setenv("SUBGC_PROCESS_ID", "0")
    assert D.maybe_initialize_distributed(backend="gloo") is True
    try:
        assert dist.get_backend() == "gloo"
        assert (D.get_process_index(), D.get_process_count()) == (0, 1)
        assert D.maybe_initialize_distributed() is True     # already up
        g = dist.group.WORLD
        # the differentiable sum carries its gradient back
        x = torch.tensor([1.0, 2.0], requires_grad=True)
        y = D.all_reduce_sum(x * 3.0, g)
        (gx,) = torch.autograd.grad(y.sum(), x)
        np.testing.assert_array_equal(gx.numpy(), [3.0, 3.0])
        # the flat bucket: a leaf the loss does not reach sums as zeros
        leaves = [torch.ones(2, 3), torch.ones(4)]
        out = D.all_reduce_gradients([torch.full((2, 3), 2.0), None],
                                     leaves, g)
        assert [t.shape for t in out] == [(2, 3), (4,)]
        assert float(out[0].sum()) == 12.0 and float(out[1].abs().sum()) == 0
        arr = np.arange(6).reshape(2, 3)
        got = D.all_gather_arrays(arr, g)
        assert len(got) == 1
        np.testing.assert_array_equal(got[0], arr)
        with D.data_parallel(g):
            assert D.active_group() is g
        assert D.active_group() is None
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("rank,world,axis", [(0, 2, 0), (1, 2, 0),
                                             (2, 3, 0), (1, 4, 1)])
def test_rank_draws_are_its_rows_of_the_global_draw(monkeypatch, rank,
                                                    world, axis):
    shape = (3, 5, 2) if axis == 0 else (4, 3, 2)
    glob = list(shape)
    glob[axis] *= world
    want = torch.rand(glob, generator=torch.Generator().manual_seed(9))
    want = want.narrow(axis, rank * shape[axis], shape[axis])
    monkeypatch.setattr(D._ACTIVE, "group", object())
    monkeypatch.setattr(D._ACTIVE, "rank", rank)
    monkeypatch.setattr(D._ACTIVE, "world", world)
    got = D.rand_rows(shape, torch.Generator().manual_seed(9), "cpu",
                      axis=axis)
    assert torch.equal(got, want)


def test_mesh_round_trips():
    cpu = torch.device("cpu")
    mesh = M.make_mesh(devices=[cpu] * 4)
    assert mesh.size == 4 and mesh.devices == (cpu,) * 4
    assert M.make_mesh(n_data=2, devices=[cpu] * 4).size == 2
    with pytest.raises(ValueError, match="needs 5 devices"):
        M.make_mesh(n_data=5, devices=[cpu] * 4)
    graph = SceneGraph(*(np.random.RandomState(i).rand(7, 3, 2)
                         .astype(np.float32) for i in range(4)))
    tree = {"g": graph, "rows": torch.arange(7), "none": None}
    chunks = M.shard_leading_axis(mesh, tree)
    assert [c["rows"].tolist() for c in chunks] == \
        [[0, 1], [2, 3], [4, 5], [6]]           # tensor_split: uneven
    assert all(c["none"] is None for c in chunks)
    back = M.gather_leading_axis(chunks)
    assert torch.equal(back["rows"], torch.arange(7))
    for a, b in zip(back["g"], graph):
        np.testing.assert_array_equal(a.numpy(), b)
    reps = M.replicate(mesh, {"w": np.ones((2, 2), np.float32)})
    assert len(reps) == 4 and all(r["w"].device == cpu for r in reps)
    t = torch.ones(3)
    assert M.replicate(M.make_mesh(devices=[cpu]), t)[0] is t


def test_one_ulp_away_moves_every_element_by_one_ulp():
    tree = {"w": np.random.RandomState(0).randn(50, 40).astype(np.float32),
            "l": [np.array([0.0, 1.0, -3.5], np.float32)]}
    moved = PS.one_ulp_away(tree, seed=1)
    for a, b in ((tree["w"], moved["w"]), (tree["l"][0], moved["l"][0])):
        assert b.dtype == np.float32 and b.shape == a.shape
        up, down = np.nextafter(a, np.float32(np.inf)), \
            np.nextafter(a, np.float32(-np.inf))
        assert np.all((b == up) | (b == down))
    assert 0.4 < (moved["w"] > tree["w"]).mean() < 0.6
    assert np.array_equal(PS.one_ulp_away(tree, seed=1)["w"], moved["w"])


def test_make_mesh_defaults_to_the_attached_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert M.make_mesh().devices == tuple(torch.device("cuda", i)
                                          for i in range(3))


def test_backend_choice():
    assert launch.pick_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert launch.pick_backend(["cuda:0", "cuda:0"]) == "gloo"
    assert launch.pick_backend(["cpu", "cpu"]) == "gloo"
    assert 0 < launch.free_port() < 65536
