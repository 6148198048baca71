"""The port's test CLI (``python -m subgc_tpu_torch.cli.test``) against the
JAX package's, on one checkpoint written by the JAX package's
``save_checkpoint`` from ``init_params``: the two ``captions_*.npy`` /
``ctl_captions_*.npy`` artifacts are equal entry by entry (sGPN scores
within atol 1e-5).  ``--n_devices`` / ``--shard_subgraphs``,
``--packed_path`` and ``--group_size``, each refused until it was ported,
decode.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

import subgc_tpu.config as JC
from subgc_tpu.cli import test as j_cli
from subgc_tpu.data.synthetic import generate_dataset
from subgc_tpu.io.sg_npz import SGDir
from subgc_tpu.models.params import init_params as j_init_params
from subgc_tpu.train.checkpoint import save_checkpoint
from subgc_tpu_torch.cli import test as p_cli


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Synthetic data, SCT region sets from the test images' own boxes
    (tests/test_cli_sct.py) and a Sub-GC checkpoint."""
    root = tmp_path_factory.mktemp("port_cli")
    man = generate_dataset(str(root / "d"), n_images=10, vocab_size=40,
                           feat_dim=64, n_subgraphs=6, seed=37)
    mcfg = JC.ModelConfig(vocab_size=40, rnn_size=48, input_encoding_size=32,
                          att_hid_size=24, gcn_dim=32, fc_feat_size=48,
                          att_feat_size=64, embed_dim=16,
                          num_obj_classes=man["n_obj_classes"],
                          num_rel_classes=man["n_rel_classes"])
    params, state = j_init_params(jax.random.PRNGKey(4), mcfg,
                                  n_obj_names=mcfg.num_obj_classes,
                                  n_pred_names=mcfg.num_rel_classes)
    ckpt = str(root / "ckpt")
    save_checkpoint(ckpt, params, state, None,
                    {"iter": 2, "model_type": "Sub_GC_Kar",
                     "model_config": JC.config_to_json(mcfg)}, {})
    with open(man["input_json"]) as f:
        images = json.load(f)["images"]
    sg = SGDir(man["sg_dir"])
    rng = np.random.RandomState(0)
    sct_dict, img_wh = {}, {}
    for img in images:
        if img["split"] != "test":
            continue
        boxes = np.asarray(sg.get(img["id"])["boxes"])
        img_wh[img["id"]] = (592, 592)
        rs = np.zeros((3, 2, 5))
        for g in range(3):
            rs[g, 0, :4] = boxes[rng.randint(boxes.shape[0])]
            rs[g, 0, 4] = 1
        sct_dict[str(img["id"])] = rs
    np.save(str(root / "sct.npy"), sct_dict)
    np.save(str(root / "wh.npy"), img_wh)
    common = ["--checkpoint_path", ckpt, "--bucket", "8",
              "--batch_images", "2",
              "--sct_dict", str(root / "sct.npy"),
              "--img_wh", str(root / "wh.npy"),
              "--input_json", man["input_json"],
              "--input_label_h5", man["input_label_h5"],
              "--sg_dir", man["sg_dir"], "--mask_dir", man["mask_dir"]]
    return ckpt, common


@pytest.mark.parametrize("preset,name", [("Sub_GC_Kar", "captions"),
                                         ("Sub_GC_Flickr_CTL",
                                          "ctl_captions")])
def test_cli_artifacts_match_jax(run, preset, name):
    ckpt, common = run
    j = j_cli.main([preset, "--iter_tag", f"{preset}_jax"] + common)
    p = p_cli.main([preset, "--iter_tag", f"{preset}_torch",
                    "--device", "cpu"] + common)
    assert os.path.basename(j["captions_path"]) == f"{name}_{preset}_jax.npy"
    assert os.path.basename(p["captions_path"]) == \
        f"{name}_{preset}_torch.npy"
    jp = np.load(j["captions_path"], allow_pickle=True).tolist()
    pp = np.load(p["captions_path"], allow_pickle=True).tolist()
    assert len(pp) == len(jp) == 2
    for a, b in zip(pp, jp):
        assert sorted(a) == sorted(b)
        assert a["image_id"] == b["image_id"]
        assert a["caption"] == b["caption"]
        np.testing.assert_array_equal(a["sorted_subgraph_ind"],
                                      b["sorted_subgraph_ind"])
        np.testing.assert_allclose(a["subgraph_score"], b["subgraph_score"],
                                   rtol=0, atol=1e-5)
    if preset == "Sub_GC_Flickr_CTL":
        assert all(len(a["caption"]) == 3 for a in pp)


def pack_run_data(common, path):
    """A packed shard of the ``run`` fixture's dataset at ``path``."""
    from subgc_tpu_torch.data import packed as P
    flags = dict(zip(common[::2], common[1::2]))
    with open(flags["--input_json"]) as f:
        images = json.load(f)["images"]
    sg, masks = SGDir(flags["--sg_dir"]), SGDir(flags["--mask_dir"])
    first = sg.get(images[0]["id"])
    spec = P.PackedSpec(feat_dim=first["object_fmap"].shape[1],
                        n_obj_cls=first["object_dist"].shape[1],
                        n_rel_cls=first["pred_dist"].shape[1], max_subg=16)
    P.write_shard(path, spec, [P.pack_image(spec, im["id"], sg.get(im["id"]),
                                            masks.get(im["id"]))
                               for im in images])
    return path


@pytest.mark.parametrize("flags", [
    ["--n_devices", "2"], ["--shard_subgraphs"],
    ["--packed_path", "shards/*.bin"], ["--group_size", "2"]])
def test_cli_refuses_unported_flags(run, tmp_path, flags):
    """Flags refused until they were ported now decode.  ``--n_devices
    2`` (the image axis over two CPU entries) and ``--shard_subgraphs``
    (with ``--n_devices 3``, the flat sub-graph rows in uneven chunks) give
    the one-device run's captions, keep sets and scores; the JAX CLI's bad
    combinations stop with its messages.  A packed shard's captions equal
    the npz run's, and two groups of two beams give one caption per kept
    sub-graph."""
    ckpt, common = run
    base = ["Sub_GC_Kar", "--device", "cpu"]
    if flags[0] == "--n_devices":
        with pytest.raises(SystemExit, match="must be divisible by "
                                             "--n_devices 3"):
            p_cli.main(base + common + ["--n_devices", "3"])
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.cuda, "is_available", lambda: True)
            mp.setattr(torch.cuda, "device_count", lambda: 1)
            with pytest.raises(SystemExit, match="--n_devices 2 > 1 "
                                                 "attached devices"):
                p_cli.main(["Sub_GC_Kar"] + common + flags)
    elif flags[0] == "--shard_subgraphs":
        with pytest.raises(SystemExit, match="requires --n_devices > 1"):
            p_cli.main(base + common + flags)
        flags = flags + ["--n_devices", "3"]
    elif flags[0] == "--packed_path":
        os.makedirs(tmp_path / "shards")
        pack_run_data(common, str(tmp_path / "shards" / "part-0.bin"))
        flags = ["--packed_path", str(tmp_path / "shards" / "*.bin")]
    else:
        flags = flags + ["--beam_size", "4"]
    got = p_cli.main(base + common + flags + ["--iter_tag", "flag_on"])
    want = p_cli.main(base + common + ["--iter_tag", "flag_off"])
    gp = np.load(got["captions_path"], allow_pickle=True).tolist()
    wp = np.load(want["captions_path"], allow_pickle=True).tolist()
    assert len(gp) == len(wp) == 2
    for a, b in zip(gp, wp):
        np.testing.assert_array_equal(a["sorted_subgraph_ind"],
                                      b["sorted_subgraph_ind"])
        assert len(a["caption"]) == len(b["caption"]) > 0
        if flags[0] != "--group_size":
            assert a["caption"] == b["caption"]
            np.testing.assert_allclose(a["subgraph_score"],
                                       b["subgraph_score"], rtol=1e-5)


def test_cli_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        p_cli.main(["Sub_GC_Kar", "--checkpoint_path", str(tmp_path)])
