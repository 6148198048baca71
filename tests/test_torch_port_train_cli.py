"""The port's training loader, checkpoints and ``cli/train.py`` held against
the JAX package on ``subgc_tpu.data.synthetic`` data (this needs h5py):

* ``TrainLoader``: three train batches, one across the epoch wrap, and a
  val batch equal entry for entry to the JAX loader's, both with
  ``native_sampler=False`` (the Python sampler; the C++ sampler's defaults
  are ``test_torch_port_native.py``'s) and the same seed (Sub-GC and the
  Sup. model);
* checkpoints load both ways (params and state exactly equal), a JAX
  ``optimizer.npz`` is not loaded (moments restart, with a warning), and
  ``optimistic_restore`` with ``word_mapping`` equals the JAX package's;
* ``python -m subgc_tpu_torch.cli.train --max_iters 3 --device cpu``
  started from a JAX checkpoint writes ``model.npz``, ``infos.json`` and
  ``histories.json`` that the JAX ``load_checkpoint`` and the port's
  ``cli/test.py`` read, with the JAX CLI's history keys; ``--auto_resume``
  picks up the port's own Adam moments.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

import subgc_tpu.config as JC
from subgc_tpu.data.dataset import TrainLoader as JTrainLoader
from subgc_tpu.data.synthetic import generate_dataset
from subgc_tpu.train import checkpoint as JCK
from subgc_tpu.train.optim import build_optimizer
from subgc_tpu_torch.cli import test as p_test_cli
from subgc_tpu_torch.cli import train as p_cli
from subgc_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from subgc_tpu_torch.data.dataset import TrainLoader
from subgc_tpu_torch.models.params import (init_params, init_params_numpy,
                                           params_to_numpy)
from subgc_tpu_torch.train import checkpoint as C
from subgc_tpu_torch.train.optim import init_opt_state

from .test_torch_port_train import flat_paths, one_thread  # noqa: F401

DIMS = dict(rnn_size=48, input_encoding_size=32, att_hid_size=24,
            gcn_dim=32)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_train")
    # 2048-wide features: the train presets' att_feat_size, which the
    # CLI has no flag for
    man = generate_dataset(str(root / "d"), n_images=10, vocab_size=40,
                           n_subgraphs=6, seed=41)
    return root, man


def _dcfg(man, cls):
    return cls(input_json=man["input_json"],
               input_label_h5=man["input_label_h5"], sg_dir=man["sg_dir"],
               mask_dir=man["mask_dir"], obj_name_path=man["obj_name_path"],
               rel_name_path=man["rel_name_path"])


@pytest.mark.parametrize("gt", [False, True])
def test_train_loader_batches_equal_jax(data, gt):
    """6 train images at batch 4: batch 2 wraps the epoch (reshuffled from
    the loaders' numpy stream), batch 3 continues; then a val batch."""
    _, man = data
    kw = dict(batch_size=4)
    jl = JTrainLoader(JC.ModelConfig(use_gt_subg=gt), JC.TrainConfig(**kw),
                      _dcfg(man, JC.DataConfig), seed=7, native_sampler=False)
    pl = TrainLoader(ModelConfig(use_gt_subg=gt), TrainConfig(**kw),
                     _dcfg(man, DataConfig), seed=7, native_sampler=False)
    assert len(pl.split_ix["train"]) == 6
    wraps = []
    for split in ("train", "train", "train", "val"):
        jb, ji, jw = jl.get_batch(split)
        pb, pi, pw = pl.get_batch(split)
        assert pi == ji and pw == jw
        wraps.append(pw)
        for name in ("labels", "masks", "sub_obj_ind", "sub_att_mask",
                     "img_ix"):
            a, b = getattr(pb, name), getattr(jb, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        for a, b in zip(pb.graph, jb.graph):
            np.testing.assert_array_equal(a, b)
    assert wraps[:3] == [False, True, False]


def _tiny(**kw):
    return dict(vocab_size=40, num_obj_classes=30, num_rel_classes=10,
                att_feat_size=64, fc_feat_size=48, embed_dim=16, **DIMS,
                **kw)


def test_checkpoints_load_both_ways(tmp_path, capsys):
    cfg = ModelConfig(**_tiny(gcn_bn=True, use_gpn=False))
    params, state = init_params(cfg, seed=2, device="cpu",
                                requires_grad=True)
    opt = init_opt_state(params, TrainConfig())
    C.save_checkpoint(str(tmp_path / "port"), params, state, opt,
                      {"iter": 5, "epoch": 1}, {"loss_history": {"5": 1.0}})
    jp, js, _, infos, hist = JCK.load_checkpoint(str(tmp_path / "port"))
    assert infos == {"iter": 5, "epoch": 1}
    assert hist == {"loss_history": {"5": 1.0}}
    for got, want in ((jp, params), (js, state)):
        g, w = flat_paths(got), flat_paths(want)
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    p2, s2, moments, infos2, _ = C.load_checkpoint(
        str(tmp_path / "port"), params_template=flat_params(params))
    assert moments.count == 0 and infos2 == infos
    assert not hasattr(p2["decoder"]["logit"]["w"], "requires_grad")

    jparams, jstate = init_params_numpy(ModelConfig(**_tiny()), seed=4)
    jopt = build_optimizer(JC.TrainConfig())
    JCK.save_checkpoint(str(tmp_path / "jax"), jparams, jstate,
                        jopt.init(jparams), {"iter": 2}, {})
    capsys.readouterr()
    pp, ps, moments, infos, _ = C.load_checkpoint(
        str(tmp_path / "jax"), params_template=jax.tree_util.tree_map(
            np.asarray, jparams))
    assert moments is None and infos == {"iter": 2}
    assert "reinitializing moments" in capsys.readouterr().out
    for got, want in ((pp, jparams), (ps, jstate)):
        g, w = flat_paths(got), flat_paths(want)
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def flat_params(params):
    """numpy copy of a params tree (the template a resume checks against)."""
    return params_to_numpy(params)


def test_optimistic_restore_word_mapping_equals_jax():
    rng = np.random.RandomState(3)
    cur = {"decoder": {"embed": rng.randn(9, 4).astype("f"),
                       "logit": {"w": rng.randn(4, 9).astype("f"),
                                 "b": rng.randn(9).astype("f")},
                       "h2att": {"w": rng.randn(4, 3).astype("f")}},
           "gcn": [[{"lft": rng.randn(2, 2).astype("f")}]]}
    loaded = {"decoder": {"embed": rng.randn(12, 4).astype("f"),
                          "logit": {"w": rng.randn(4, 12).astype("f"),
                                    "b": rng.randn(12).astype("f")},
                          "h2att": {"w": rng.randn(4, 3).astype("f")}},
              "gcn": [[{"lft": rng.randn(3, 2).astype("f")}]]}
    wm = np.asarray([0, 3, 2, -1, 11, 5, -1, 7, 8])
    got = C.optimistic_restore(cur, loaded, word_mapping=wm, verbose=False)
    want = JCK.optimistic_restore(cur, loaded, word_mapping=wm,
                                  verbose=False)
    g, w = flat_paths(got), flat_paths(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k])
    np.testing.assert_array_equal(g[("decoder", "embed")][1],
                                  loaded["decoder"]["embed"][3])
    np.testing.assert_array_equal(g[("gcn", 0, 0, "lft")], cur["gcn"][0][0]
                                  ["lft"])


def _data_flags(man):
    return ["--input_json", man["input_json"],
            "--input_label_h5", man["input_label_h5"],
            "--sg_dir", man["sg_dir"], "--mask_dir", man["mask_dir"],
            "--obj_name_path", man["obj_name_path"],
            "--rel_name_path", man["rel_name_path"]]


def _dim_flags():
    return [x for k, v in DIMS.items() for x in (f"--{k}", str(v))]


def test_cli_trains_from_a_jax_checkpoint(data, capsys):
    root, man = data
    mcfg, _, _ = JC.build_configs("Sub_GC_Kar", mode="train",
                                  model=dict(DIMS))
    mcfg = mcfg.replace(vocab_size=man["vocab_size"],
                        seq_length=man["seq_length"])
    jparams, jstate = init_params_numpy(
        ModelConfig(**{f: getattr(mcfg, f)
                       for f in ModelConfig.__dataclass_fields__}), seed=5,
        n_obj_names=man["n_obj_classes"], n_pred_names=man["n_rel_classes"])
    start = str(root / "jax_start")
    JCK.save_checkpoint(start, jparams, jstate,
                        build_optimizer(JC.TrainConfig()).init(jparams),
                        {"iter": 0, "epoch": 0}, {})
    out = str(root / "port_run")
    common = ["Sub_GC_Kar", "--checkpoint_path", out, "--device", "cpu",
              "--batch_size", "2", "--save_checkpoint_every", "3",
              "--val_images_use", "2", "--losses_log_every", "1"]
    flags = common + _dim_flags() + _data_flags(man)
    res = p_cli.main(flags + ["--start_from", start, "--max_iters", "3"])
    assert res == {"iter": 3, "epoch": 0}       # 6 train images
    assert "reinitializing moments" in capsys.readouterr().out

    for name in ("model.npz", "optimizer.npz", "infos.json",
                 "histories.json", "metrics.jsonl"):
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "histories.json")) as f:
        hist = json.load(f)
    assert sorted(hist) == ["loss_history", "lr_history", "ss_prob_history",
                            "val_loss_history"]
    assert sorted(hist["loss_history"], key=int) == ["1", "2", "3"]
    assert hist["lr_history"]["1"] == 0.0          # LR 0 at iteration 0
    assert np.isfinite(hist["val_loss_history"]["3"])
    jp, js, _, infos, _ = JCK.load_checkpoint(out)
    assert infos["iter"] == 3 and infos["model_type"] == "Sub_GC_Kar"
    loaded_cfg = JC.config_from_json(JC.ModelConfig, infos["model_config"])
    assert loaded_cfg.rnn_size == DIMS["rnn_size"]
    moved = [k for k, v in flat_paths(jp).items()
             if not np.array_equal(v, flat_paths(jparams)[k])]
    assert ("decoder", "logit", "w") in moved

    res = p_cli.main(flags + ["--auto_resume", "1", "--max_iters", "4"])
    assert res["iter"] == 4
    assert "reinitializing" not in capsys.readouterr().out
    with np.load(os.path.join(out, "optimizer.npz")) as z:
        assert int(z["count"]) == 4

    caps = p_test_cli.main(["Sub_GC_Kar", "--checkpoint_path", out,
                            "--device", "cpu", "--bucket", "8",
                            "--batch_images", "2", "--num_images", "2"]
                           + [x for x in _data_flags(man)[:8]])
    preds = np.load(caps["captions_path"], allow_pickle=True).tolist()
    assert len(preds) == 2 and all(p["caption"] for p in preds)


@pytest.mark.parametrize("flags", [
    ["--n_devices", "4"], ["--n_devices", "2"],
    ["--trace_steps", "1:2"], ["--packed_path", "shards/*.bin"]])
def test_cli_refuses_unported_flags(data, tmp_path, flags):
    """Flags refused until they were ported now train.  ``--n_devices``
    (4 shrinks to 2, the most that divides the batch of 2, as in the JAX
    CLI) spawns two gloo ranks that log the one-process run's losses and
    whose rank-0 checkpoint equals its (rtol 2e-4 / atol 1e-6); a trace of
    steps 1-2 is written; a run over a packed shard of the dataset logs the
    npz run's losses."""
    _, man = data
    common = ["Sub_GC_Kar", "--device", "cpu", "--batch_size", "2",
              "--save_checkpoint_every", "2", "--val_images_use", "2",
              "--losses_log_every", "1", "--max_iters", "2"] + _dim_flags()
    if flags[0] == "--packed_path":
        from subgc_tpu_torch.data import packed as P
        from subgc_tpu_torch.io.sg_npz import SGDir
        with open(man["input_json"]) as f:
            images = json.load(f)["images"]
        sg, masks = SGDir(man["sg_dir"]), SGDir(man["mask_dir"])
        spec = P.PackedSpec(feat_dim=man["feat_dim"],
                            n_obj_cls=man["n_obj_classes"],
                            n_rel_cls=man["n_rel_classes"], max_subg=16)
        os.makedirs(tmp_path / "shards")
        P.write_shard(str(tmp_path / "shards" / "a.bin"), spec,
                      [P.pack_image(spec, im["id"], sg.get(im["id"]),
                                    masks.get(im["id"])) for im in images])
        flags = ["--packed_path", str(tmp_path / "shards" / "*.bin")]
        on_flags = _data_flags(man)[:4] + _data_flags(man)[8:] + flags
    else:
        on_flags = _data_flags(man) + flags
    runs = {}
    for name, extra in (("on", on_flags), ("off", _data_flags(man))):
        out = str(tmp_path / name)
        assert p_cli.main(common + extra + ["--checkpoint_path", out]) == \
            {"iter": 2, "epoch": 0}
        with open(os.path.join(out, "histories.json")) as f:
            runs[name] = json.load(f)["loss_history"]
    if flags[0] == "--trace_steps":
        assert os.path.getsize(tmp_path / "on" / "trace" / "trace.json") > 0
    assert sorted(runs["on"]) == sorted(runs["off"]) == ["1", "2"]
    np.testing.assert_allclose([runs["on"][k] for k in ("1", "2")],
                               [runs["off"][k] for k in ("1", "2")],
                               rtol=1e-5 if flags[0] == "--n_devices"
                               else 1e-6)
    if flags[0] == "--n_devices":
        (on, on_state), (off, off_state) = (
            JCK.load_checkpoint(str(tmp_path / name))[:2]
            for name in ("on", "off"))
        for part_on, part_off in ((on, off), (on_state, off_state)):
            g, w = flat_paths(part_on), flat_paths(part_off)
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=2e-4, atol=1e-6,
                                           err_msg=str(k))


@pytest.mark.parametrize("mode", ["scst", "sgd"])
def test_cli_trains_with_scst_and_another_optimizer(mode, data, capsys):
    """``--self_critical_after 0`` trains with SCST from the first
    iteration (one ``scst iter 0`` line, the iteration the JAX CLI logs
    at), ``--optim sgd`` with optax's SGD; each logs finite losses and
    writes a checkpoint that both packages load, its optimizer state of
    the optimizer that ran, which another ``--optim`` cannot resume."""
    root, man = data
    out = str(root / f"port_{mode}")
    extra = (["--self_critical_after", "0"] if mode == "scst"
             else ["--optim", "sgd"])
    flags = (["Sub_GC_Kar", "--checkpoint_path", out, "--device", "cpu",
              "--batch_size", "2", "--save_checkpoint_every", "3",
              "--val_images_use", "2", "--losses_log_every", "1",
              "--max_iters", "3"] + _dim_flags() + _data_flags(man) + extra)
    assert p_cli.main(flags) == {"iter": 3, "epoch": 0}
    log = capsys.readouterr().out
    assert ("scst iter 0: loss" in log) == (mode == "scst")
    with open(os.path.join(out, "histories.json")) as f:
        hist = json.load(f)
    assert sorted(hist["loss_history"], key=int) == ["1", "2", "3"]
    assert all(np.isfinite(v) for v in hist["loss_history"].values())
    jp, _, _, infos, _ = JCK.load_checkpoint(out)
    assert infos["iter"] == 3
    optim = "adam" if mode == "scst" else "sgd"
    assert JC.config_from_json(JC.TrainConfig,
                               infos["train_config"]).optim == optim
    pp, _, opt, _, _ = C.load_checkpoint(out, params_template=jp,
                                         optim=optim)
    assert (opt.kind, opt.count) == (optim, 3)
    g, w = flat_paths(pp), flat_paths(jp)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k])
    with pytest.raises(ValueError, match=f"holds '{optim}'"):
        p_cli.main(flags[:-2] + ["--optim", "rmsprop", "--auto_resume", "1",
                                 "--max_iters", "4"])


def test_cli_trains_on_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        p_cli.main(["Sub_GC_Kar", "--checkpoint_path", str(tmp_path)])
