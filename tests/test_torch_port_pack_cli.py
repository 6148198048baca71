"""The port's shard packer (``python -m subgc_tpu_torch.cli.pack``) against
the JAX package's ``tools/pack_dataset.py`` on a ``generate_dataset``
corpus: with the same flags the two shards are byte for byte the same,
with and without ``--mask_dir``, and the port's ``PackedShard`` reads the
port's shard back.
"""
import json
import sys

import numpy as np
import pytest

from subgc_tpu.data.synthetic import generate_dataset
from subgc_tpu_torch.cli import pack as p_pack
from subgc_tpu_torch.data.packed import PackedShard
from tools import pack_dataset as j_pack


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_pack")
    return root, generate_dataset(str(root / "d"), n_images=7, feat_dim=64,
                                  n_subgraphs=5, seed=31)


@pytest.mark.parametrize("masks", [True, False])
def test_port_shard_is_the_jax_tools_byte_for_byte(corpus, masks,
                                                   monkeypatch, capsys):
    root, man = corpus
    tag = "masks" if masks else "nomasks"
    flags = ["--input_json", man["input_json"], "--sg_dir", man["sg_dir"],
             "--max_subg", "16", "--feat_dim", "64",
             "--n_obj_cls", str(man["n_obj_classes"]),
             "--n_rel_cls", str(man["n_rel_classes"])]
    if masks:
        flags += ["--mask_dir", man["mask_dir"]]
    port, jax_out = str(root / f"port_{tag}.bin"), str(root / f"jax_{tag}.bin")
    assert p_pack.main(flags + ["--out", port]) == port
    monkeypatch.setattr(sys, "argv", ["pack_dataset.py"] + flags
                        + ["--out", jax_out])
    j_pack.main()
    out = capsys.readouterr().out
    assert out.count("wrote") == 2
    with open(port, "rb") as a, open(jax_out, "rb") as b:
        got, want = a.read(), b.read()
    assert len(got) > 64 and got == want
    with open(man["input_json"]) as f:
        ids = [im["id"] for im in json.load(f)["images"]]
    shard = PackedShard(port, use_native=False)
    assert shard.n_images == len(ids)
    np.testing.assert_array_equal(shard.image_ids(), ids)
    rec = shard.record(3)
    assert rec["img_id"] == ids[3]
    assert bool(np.asarray(rec["sub_att_mask"]).any()) == masks
