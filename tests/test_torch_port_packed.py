"""Packed shards in the port against the JAX package's format and loaders.

* A shard written by JAX's ``write_shard`` reads the same through both of
  the port's readers (C++ and numpy) as through JAX's, and the port's
  ``pack_image`` / ``write_shard`` write the same bytes.
* The port's loaders with ``packed_path`` equal its npz loaders and the JAX
  package's packed loaders: eval examples and train batches (the C++
  sampler), as ``tests/test_packed_loader.py`` holds JAX; ``PackedMaskSource
  .get`` (the npz interface) equals JAX's.
* Shards in a glob or a comma list read as one; a missing shard, a file
  with a bad magic or a short tail, and an index out of range are refused.
* ``cli/test.py --packed_path`` writes the captions of the npz run.
"""
import json
import struct

import numpy as np
import pytest

import subgc_tpu.config as JC
from subgc_tpu.data import packed as JP
from subgc_tpu.data import packed_adapter as JPA
from subgc_tpu.data.dataset import EvalLoader as JEvalLoader
from subgc_tpu.data.dataset import TrainLoader as JTrainLoader
from subgc_tpu.data.synthetic import generate_dataset
from subgc_tpu.io.sg_npz import SGDir
from subgc_tpu_torch.cli import test as p_cli
from subgc_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from subgc_tpu_torch.data import packed as P
from subgc_tpu_torch.data import packed_adapter as PA
from subgc_tpu_torch.data.dataset import EvalLoader, TrainLoader

from .test_torch_port_cli import pack_run_data, run  # noqa: F401


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    """8 synthetic images; one JAX shard of all, two port shards of halves."""
    root = tmp_path_factory.mktemp("port_packed")
    man = generate_dataset(str(root / "d"), n_images=8, seed=29,
                           n_subgraphs=9)
    with open(man["input_json"]) as f:
        images = json.load(f)["images"]
    sg, masks = SGDir(man["sg_dir"]), SGDir(man["mask_dir"])
    kw = dict(feat_dim=man["feat_dim"], n_obj_cls=man["n_obj_classes"],
              n_rel_cls=man["n_rel_classes"], max_subg=16)
    jspec, pspec = JP.PackedSpec(**kw), P.PackedSpec(**kw)
    assert tuple(jspec) == tuple(pspec)
    assert jspec.record_size == pspec.record_size
    jrecs = [JP.pack_image(jspec, im["id"], sg.get(im["id"]),
                           masks.get(im["id"])) for im in images]
    precs = [P.pack_image(pspec, im["id"], sg.get(im["id"]),
                          masks.get(im["id"])) for im in images]
    JP.write_shard(str(root / "jax.bin"), jspec, jrecs)
    P.write_shard(str(root / "port.bin"), pspec, precs)
    P.write_shard(str(root / "part-0.bin"), pspec, precs[:4])
    P.write_shard(str(root / "part-1.bin"), pspec, precs[4:])
    return root, man, images


def _same_record(a, b, names):
    for name in names:
        x, y = a[name], b[name]
        if name == "img_id":
            assert x == y and isinstance(x, int)
        else:
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_port_writes_the_jax_bytes_and_reads_jax_shards(ds):
    root, _, images = ds
    with open(root / "jax.bin", "rb") as f:
        jbytes = f.read()
    with open(root / "port.bin", "rb") as f:
        assert f.read() == jbytes
    jshard = JP.PackedShard(str(root / "jax.bin"), use_native=False)
    names = [n for n, _, _ in jshard.spec.record_fields()]
    for use_native in (True, False):
        shard = P.PackedShard(str(root / "jax.bin"), use_native=use_native)
        assert (shard._native is not None) == use_native
        assert shard.n_images == len(images)
        np.testing.assert_array_equal(shard.image_ids(),
                                      [im["id"] for im in images])
        for i in range(len(images)):
            _same_record(shard.record(i), jshard.record(i), names)
    # the C++ reader's batched copy of raw records
    got = P.PackedShard(str(root / "jax.bin"))._native.gather([3, 0, 3])
    size = jshard.spec.record_size
    assert got.shape == (3, size) and got.dtype == np.uint8
    assert got[0].tobytes() == jbytes[64 + 3 * size:64 + 4 * size]
    assert got[1].tobytes() == jbytes[64:64 + size]
    assert got[2].tobytes() == got[0].tobytes()


def test_mask_source_npz_interface_equals_jax(ds):
    root, _, images = ds
    path = str(root / "jax.bin")
    jm, pm = JPA.PackedMaskSource(path), PA.PackedMaskSource(path)
    js, ps = JPA.PackedSGSource(path), PA.PackedSGSource(path)
    for im in images:
        a, b = pm.get(im["id"]), jm.get(im["id"])
        np.testing.assert_array_equal(a["node_iou_mtx"], b["node_iou_mtx"])
        assert len(a["subgraph_mask_list"]) == len(b["subgraph_mask_list"])
        for ea, eb in zip(a["subgraph_mask_list"], b["subgraph_mask_list"]):
            for x, y in zip(ea[1:], eb[1:]):
                np.testing.assert_array_equal(x, y)
        fa, fb = pm.get_fast(im["id"]), jm.get_fast(im["id"])
        assert sorted(fa) == sorted(fb) and fa["total"] == fb["total"]
        for k in ("node_iou_mtx", "sub_obj_ind", "sub_att_mask",
                  "sub_pred_ind"):
            np.testing.assert_array_equal(fa[k], fb[k])
        sa, sb = ps.get(im["id"]), js.get(im["id"])
        assert sorted(sa) == sorted(sb)
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k])


def _cfgs(man):
    kw = dict(vocab_size=man["vocab_size"], rnn_size=48,
              input_encoding_size=32, att_hid_size=24, gcn_dim=32,
              fc_feat_size=48, att_feat_size=man["feat_dim"], embed_dim=16,
              num_obj_classes=man["n_obj_classes"],
              num_rel_classes=man["n_rel_classes"])
    return JC.ModelConfig(**kw), ModelConfig(**kw)


def _dcfgs(man, packed):
    base = dict(input_json=man["input_json"],
                input_label_h5=man["input_label_h5"])
    if packed:
        return (JC.DataConfig(packed_path=packed, **base),
                DataConfig(packed_path=packed, **base))
    return (JC.DataConfig(sg_dir=man["sg_dir"], mask_dir=man["mask_dir"],
                          **base),
            DataConfig(sg_dir=man["sg_dir"], mask_dir=man["mask_dir"],
                       **base))


def test_eval_examples_packed_equal_npz_and_jax(ds):
    root, man, _ = ds
    jm, pm = _cfgs(man)
    packed = str(root / "jax.bin")
    loaders = [EvalLoader(pm, _dcfgs(man, None)[1], bucket=16),
               EvalLoader(pm, _dcfgs(man, packed)[1], bucket=16),
               JEvalLoader(jm, _dcfgs(man, packed)[0], bucket=16)]
    assert hasattr(loaders[1].masks, "get_fast")
    n = len(loaders[0])
    assert n > 0 and all(len(x) == n for x in loaders)
    for pos in range(n):
        want = loaders[0].example(pos)
        for other in loaders[1:]:
            ex = other.example(pos)
            assert ex.info == want.info and ex.n_subgraphs == want.n_subgraphs
            for a, b in zip(ex.subs, want.subs):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(ex.graph, want.graph):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(ex.gts, want.gts)


@pytest.mark.parametrize("gt", [False, True])
def test_train_batches_packed_equal_npz_and_jax(ds, gt):
    """The gather over left-packed rows equals the npz re-packing; the same
    seed drives the same C++ sampler draws (4 batches: a wrap included)."""
    root, man, _ = ds
    jm, pm = _cfgs(man)
    jm, pm = jm.replace(use_gt_subg=gt), pm.replace(use_gt_subg=gt)
    packed = str(root / "part-*.bin")
    tk = dict(batch_size=4)
    loaders = [TrainLoader(pm, TrainConfig(**tk), _dcfgs(man, None)[1],
                           seed=7),
               TrainLoader(pm, TrainConfig(**tk), _dcfgs(man, packed)[1],
                           seed=7),
               JTrainLoader(jm, JC.TrainConfig(**tk), _dcfgs(man, packed)[0],
                            seed=7)]
    for _ in range(4):
        want, winfo, wwrap = loaders[0].get_batch("train")
        for other in loaders[1:]:
            b, info, wrap = other.get_batch("train")
            assert [x.id for x in info] == [x.id for x in winfo]
            assert wrap == wwrap
            for f in ("labels", "masks", "sub_obj_ind", "sub_att_mask",
                      "img_ix"):
                a, w = getattr(b, f), getattr(want, f)
                assert a.dtype == w.dtype, f
                np.testing.assert_array_equal(a, w, err_msg=f)
            for a, w in zip(b.graph, want.graph):
                np.testing.assert_array_equal(a, w)


def test_globs_and_comma_lists_read_as_one(ds):
    root, _, images = ds
    ids = sorted(im["id"] for im in images)
    for path in (str(root / "part-*.bin"),
                 f"{root / 'part-1.bin'},{root / 'part-0.bin'}"):
        src = PA.PackedSGSource(path)
        assert len(src.shards) == 2 and sorted(src.index) == ids
        whole = PA.PackedSGSource(str(root / "port.bin"))
        for i in ids:
            a, b = src.get(i), whole.get(i)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_bad_shards_are_refused(ds, tmp_path):
    root, _, _ = ds
    with pytest.raises(FileNotFoundError, match="no shards match"):
        PA.PackedSource(str(tmp_path / "none-*.bin"))
    with pytest.raises(FileNotFoundError):
        P.PackedShard(str(tmp_path / "missing.bin"))
    good = (root / "part-0.bin").read_bytes()
    bad = tmp_path / "bad.bin"
    bad.write_bytes(struct.pack("<Q", 0x1234) + good[8:])
    for use_native in (True, False):
        with pytest.raises(ValueError, match="magic"):
            P.PackedShard(str(bad), use_native=use_native)
    bad.write_bytes(good[:-10])
    with pytest.raises(ValueError, match="bytes for 4 records"):
        P.PackedShard(str(bad))
    bad.write_bytes(good[:40])
    with pytest.raises(ValueError, match="shorter than a header"):
        P.PackedShard(str(bad))
    from subgc_tpu_torch.ops.native_packed import NativePackedReader
    with pytest.raises(RuntimeError, match="cannot open shard"):
        NativePackedReader(str(bad))
    reader = P.PackedShard(str(root / "part-0.bin"))._native
    with pytest.raises(IndexError, match="index 4 out of range"):
        reader.gather([0, 4])
    with pytest.raises(IndexError, match="-1 out of range"):
        reader.gather([-1])
    for use_native in (True, False):
        shard = P.PackedShard(str(root / "part-0.bin"), use_native=use_native)
        for i in (4, -1):
            with pytest.raises(IndexError):
                shard.record(i)


def test_cli_packed_path_captions_equal_npz(run, tmp_path):  # noqa: F811
    """The test CLI over a shard of the CLI fixture's own dataset decodes
    the npz run's captions, scores and keep sets."""
    ckpt, common = run
    shard = pack_run_data(common, str(tmp_path / "shard.bin"))
    flags = dict(zip(common[::2], common[1::2]))
    base = ["Sub_GC_Kar", "--device", "cpu", "--checkpoint_path", ckpt,
            "--bucket", "8", "--batch_images", "2",
            "--input_json", flags["--input_json"],
            "--input_label_h5", flags["--input_label_h5"]]
    a = p_cli.main(base + ["--iter_tag", "npz", "--sg_dir",
                           flags["--sg_dir"], "--mask_dir",
                           flags["--mask_dir"]])
    b = p_cli.main(base + ["--iter_tag", "packed", "--packed_path", shard])
    pa = np.load(a["captions_path"], allow_pickle=True).tolist()
    pb = np.load(b["captions_path"], allow_pickle=True).tolist()
    assert len(pa) == len(pb) == 2
    for x, y in zip(pa, pb):
        assert x["image_id"] == y["image_id"] and x["caption"] == y["caption"]
        np.testing.assert_array_equal(x["sorted_subgraph_ind"],
                                      y["sorted_subgraph_ind"])
        np.testing.assert_array_equal(x["subgraph_score"],
                                      y["subgraph_score"])
