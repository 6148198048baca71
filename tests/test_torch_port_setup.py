"""The port's model factory ``subgc_tpu_torch.setup`` against the JAX
package's ``subgc_tpu.setup``, on the CPU at tiny widths:

* from one shared checkpoint directory and a ``word_mapping`` that maps
  every new token row to an old one, both give equal params and state,
  exactly (Sub-GC, and Full-GC with its GCN BatchNorm state);
* the GloVe rows under a ``dcfg.glove_path`` equal the JAX package's
  ``io/glove.py::class_embeddings`` on a small synthetic GloVe txt;
* without a ``dcfg`` (or with name files that do not exist) the class
  counts are ``mcfg.num_*_classes``, and the fresh weights are
  ``init_params_numpy(mcfg, seed)``'s;
* ``python -m subgc_tpu_torch.cli.train --start_from --word_mapping`` at
  learning rate 0 saves exactly the restored params that ``subgc_tpu.setup``
  gives (the JAX train CLI's restore: ``optimistic_restore`` of a fresh
  init), since the CLI now goes through ``setup_numpy``.

Fresh weights differ between the packages by design (numpy's
``default_rng(seed)`` against ``PRNGKey(2019)``), so every comparison of
values starts from a checkpoint that supplies every leaf.
"""
import json
import os

import numpy as np
import pytest

import subgc_tpu
import subgc_tpu.config as JC
import subgc_tpu_torch as P
from subgc_tpu.data.synthetic import generate_dataset
from subgc_tpu.io.glove import class_embeddings as j_class_embeddings
from subgc_tpu_torch.cli import train as p_train_cli
from subgc_tpu_torch.models import setup_numpy
from subgc_tpu_torch.models.params import init_params_numpy
from subgc_tpu_torch.train import checkpoint as C

from .test_torch_port_train import flat_paths, one_thread  # noqa: F401

WIDTHS = dict(rnn_size=48, input_encoding_size=32, att_hid_size=24,
              gcn_dim=32, fc_feat_size=48, att_feat_size=64, embed_dim=16,
              num_obj_classes=12, num_rel_classes=6)


def _cfgs(preset, **over):
    model = dict(WIDTHS, **over)
    return (P.build_configs(preset, model=model)[0],
            JC.build_configs(preset, model=model)[0])


def _same(got, want):
    g, w = flat_paths(got), flat_paths(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=str(k))


def _names(tmp_path, n_obj, n_rel):
    obj = str(tmp_path / "obj_names.npy")
    rel = str(tmp_path / "rel_names.npy")
    np.save(obj, np.array(["background"] + [f"class{i}"
                                            for i in range(1, n_obj)]))
    np.save(rel, np.array(["background"] + [f"rel{i}"
                                            for i in range(1, n_rel)]))
    return obj, rel


@pytest.mark.parametrize("preset", ["Sub_GC_Kar", "Full_GC_Kar"])
def test_setup_from_a_shared_checkpoint_equals_jax(tmp_path, preset):
    cfg, jcfg = _cfgs(preset, vocab_size=30)
    old = cfg.replace(vocab_size=40)
    obj, rel = _names(tmp_path, 9, 5)
    params, state = init_params_numpy(old, seed=3, n_obj_names=9,
                                      n_pred_names=5)
    if cfg.gcn_bn:          # running statistics away from (0, 1)
        rng = np.random.RandomState(4)
        for layer in state["gcn_bn"]:
            for u in layer:
                u["mean"] = rng.normal(0, 0.1, u["mean"].shape).astype("f")
                u["var"] = rng.uniform(0.5, 1.5, u["var"].shape).astype("f")
    ckpt = str(tmp_path / "ckpt")
    C.save_checkpoint(ckpt, params, state, None, {"iter": 7}, {})
    # every new token row (31) from some old row (41): no fresh row left
    wm = np.random.RandomState(5).permutation(41)[:31]
    dcfg = P.DataConfig(obj_name_path=obj, rel_name_path=rel)
    jdcfg = JC.DataConfig(obj_name_path=obj, rel_name_path=rel)
    got = P.setup(cfg, dcfg, start_from=ckpt, word_mapping=wm, device="cpu")
    want = subgc_tpu.setup(jcfg, jdcfg, start_from=ckpt, word_mapping=wm)
    for g, w in zip(got, want):
        _same(g, w)
    emb = flat_paths(got[0])[("decoder", "embed")]
    np.testing.assert_array_equal(emb, params["decoder"]["embed"][wm])
    _same(got[1], state)
    assert got[0]["decoder"]["embed"].device.type == "cpu"


def test_glove_rows_equal_jax_class_embeddings(tmp_path):
    cfg, _ = _cfgs("Sub_GC_Kar")
    obj, rel = _names(tmp_path, 5, 4)
    glove = str(tmp_path / "glove.txt")
    rng = np.random.RandomState(6)
    words = ["background", "class1", "class3", "rel2", "rel3"]
    with open(glove, "w") as f:
        for w in words:
            f.write(w + " " + " ".join(f"{x:.5f}" for x in
                                       rng.randn(cfg.embed_dim)) + "\n")
    dcfg = P.DataConfig(obj_name_path=obj, rel_name_path=rel,
                        glove_path=glove)
    params, _, loaded = setup_numpy(cfg, dcfg, seed=1)
    assert loaded is None
    names = [list(np.load(p)) for p in (obj, rel)]
    for key, n in (("obj_emb", names[0]), ("pred_emb", names[1])):
        want = j_class_embeddings(n, glove, cfg.embed_dim)
        np.testing.assert_array_equal(params["fusion"][key], want)
    # a class with a vector takes it; one without keeps the seeded draw
    row = params["fusion"]["obj_emb"][1]
    assert np.allclose(row, [float(x) for x in
                             open(glove).read().splitlines()[1].split()[1:]])


@pytest.mark.parametrize("names", ["none", "missing"])
def test_no_name_files_use_the_config_class_counts(tmp_path, names):
    cfg, jcfg = _cfgs("Sub_GC_Kar", vocab_size=20)
    dcfg = None if names == "none" else P.DataConfig(
        obj_name_path=str(tmp_path / "absent.npy"),
        rel_name_path=str(tmp_path / "absent_rel.npy"))
    params, state = P.setup(cfg, dcfg, seed=9, device="cpu")
    fusion = params["fusion"]
    assert tuple(fusion["obj_emb"].shape) == (12, cfg.embed_dim)
    assert tuple(fusion["pred_emb"].shape) == (6, cfg.embed_dim)
    want, want_state = init_params_numpy(cfg, seed=9)
    _same(params, want)
    _same(state, want_state)
    jparams, _ = subgc_tpu.setup(jcfg)
    shapes = {k: v.shape for k, v in flat_paths(jparams).items()}
    assert {k: tuple(v.shape) for k, v in flat_paths(params).items()} == \
        shapes


def test_setup_refuses_to_fall_back_to_the_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, _ = _cfgs("Sub_GC_Kar", vocab_size=20)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.setup(cfg)


def test_train_cli_restores_as_the_jax_package(tmp_path, capsys):
    man = generate_dataset(str(tmp_path / "d"), n_images=5, vocab_size=30,
                           n_subgraphs=4, seed=8)
    dims = dict(rnn_size=48, input_encoding_size=32, att_hid_size=24,
                gcn_dim=32)
    cfg = P.build_configs("Sub_GC_Kar", mode="train", model=dims)[0]
    cfg = cfg.replace(vocab_size=36, seq_length=man["seq_length"])
    params, state = init_params_numpy(cfg, seed=2,
                                      n_obj_names=man["n_obj_classes"],
                                      n_pred_names=man["n_rel_classes"])
    start = str(tmp_path / "start")
    C.save_checkpoint(start, params, state, None, {"iter": 4, "epoch": 1},
                      {})
    wm = np.random.RandomState(3).permutation(37)[:31]
    wm_path = str(tmp_path / "word_mapping.npy")
    np.save(wm_path, wm)
    out = str(tmp_path / "run")
    data = ["--input_json", man["input_json"],
            "--input_label_h5", man["input_label_h5"],
            "--sg_dir", man["sg_dir"], "--mask_dir", man["mask_dir"],
            "--obj_name_path", man["obj_name_path"],
            "--rel_name_path", man["rel_name_path"]]
    res = p_train_cli.main(
        ["Sub_GC_Kar", "--checkpoint_path", out, "--device", "cpu",
         "--start_from", start, "--word_mapping", wm_path,
         "--learning_rate", "0", "--max_iters", "5", "--batch_size", "2",
         "--save_checkpoint_every", "5", "--val_images_use", "2"]
        + [x for k, v in dims.items() for x in (f"--{k}", str(v))] + data)
    assert res["iter"] == 5
    assert "shape mismatch at ('decoder', 'embed')" in capsys.readouterr().out
    got, got_state, _, infos, _ = C.load_checkpoint(out)
    assert infos["iter"] == 5
    jcfg = JC.build_configs("Sub_GC_Kar", mode="train", model=dims)[0]
    jcfg = jcfg.replace(vocab_size=30, seq_length=man["seq_length"])
    jdcfg = JC.DataConfig(obj_name_path=man["obj_name_path"],
                          rel_name_path=man["rel_name_path"])
    want, want_state = subgc_tpu.setup(jcfg, jdcfg, start_from=start,
                                       word_mapping=wm)
    _same(got, want)
    _same(got_state, want_state)
    with open(os.path.join(out, "infos.json")) as f:
        assert json.load(f)["model_type"] == "Sub_GC_Kar"
