"""The port's reference-checkpoint converter (``python -m
subgc_tpu_torch.cli.convert_ckpt``) against the JAX package's
``tools/convert_torch_ckpt.py``, on seeded reference-layout state_dicts at
tiny widths (``chip_smoke.py``'s ``reference_weights`` +
``reference_state_dict``: the reference's key names, ``[out, in]``
layouts and BatchNorm ``num_batches_tracked`` counters, from
``init_params_numpy`` with every BatchNorm leaf drawn from the seed), with
no reference tree and no download:

* five layouts: Sub_GC_Kar (``use_bn`` 0), ``use_bn`` 1 and 2 (the
  ``att_embed`` index shift), ``use_gt_subg`` (no ``gpn_fc``) and Full-GC
  (``gcn_bn``: the GCN BatchNorm keys, no sGPN);
* the directory form (``--pth --infos --out``): ``model.npz`` arrays equal
  the JAX tool's and the seeded arrays bitwise, ``infos.json`` equal key
  for key (config, ``model_type``, vocab, iter, epoch, source path);
* the legacy form (``CKPT OUT.npz`` with ``--use-gt-subg`` / ``--full-gc``)
  for the layouts it can name: the same arrays;
* both packages' ``cli/test.py`` decode the converted directory to the same
  captions and keep sets (the Sub-GC layouts); Full-GC, which neither test
  CLI batches, through both packages' ``encode_image`` + ``beam_search``;
* an ``opt.id`` that is not a preset falls back to Sub_GC_Kar, with the JAX
  tool's message.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import subgc_tpu.config as JC
import subgc_tpu_torch as P
from subgc_tpu.cli import test as j_test_cli
from subgc_tpu.data.synthetic import generate_dataset
from subgc_tpu.decode import beam as JB
from subgc_tpu.graph import SceneGraph as JSceneGraph
from subgc_tpu.models import subgc as JS
from subgc_tpu_torch.cli import convert_ckpt
from subgc_tpu_torch.cli import test as p_test_cli
from subgc_tpu_torch.models.params import _flatten, load_model_npz
from tools import convert_torch_ckpt as j_convert

from .test_torch_port_train import one_thread  # noqa: F401

WIDTHS = dict(vocab_size=40, rnn_size=48, input_encoding_size=32,
              att_hid_size=24, gcn_dim=32, fc_feat_size=48, att_feat_size=64,
              embed_dim=16, num_obj_classes=30, num_rel_classes=10)
LAYOUTS = {"kar": ("Sub_GC_Kar", {}, []),
           "use_bn1": ("Sub_GC_Kar", {"use_bn": 1}, None),
           "use_bn2": ("Sub_GC_Kar", {"use_bn": 2}, None),
           "gt_subg": ("Sub_GC_Kar", {"use_gt_subg": True},
                       ["--use-gt-subg"]),
           "full_gc": ("Full_GC_Kar", {}, ["--full-gc"])}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_convert")
    man = generate_dataset(str(root / "d"), n_images=10, vocab_size=40,
                           feat_dim=64, n_subgraphs=6, seed=23)
    with open(man["input_json"]) as f:
        vocab = json.load(f)["ix_to_word"]
    return root, man, vocab


def _reference(root, layout, vocab, seed):
    preset, over, _ = LAYOUTS[layout]
    cfg = P.build_configs(preset, model=dict(WIDTHS, **over))[0]
    work = root / layout
    work.mkdir(exist_ok=True)
    pth, infos, params, state = cs.write_reference_checkpoint(
        str(work), cfg, vocab, seed)
    return cfg, work, pth, infos, params, state


def _flat_bytes(tree):
    return {k: (v.dtype, v.shape, v.tobytes())
            for k, v in _flatten(tree).items()}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_converted_checkpoints_equal_the_jax_tools(data, layout, capsys):
    root, man, vocab = data
    cfg, work, pth, infos, params, state = _reference(
        root, layout, vocab, seed=sorted(LAYOUTS).index(layout))
    sd = torch.load(pth, weights_only=True)
    assert any(k.endswith("num_batches_tracked") for k in sd) == \
        bool(cfg.use_bn or cfg.gcn_bn)
    preset = LAYOUTS[layout][0]
    out_p, out_j = str(work / "port"), str(work / "jax")
    convert_ckpt.main(["--pth", pth, "--infos", infos, "--out", out_p,
                       "--model_type", preset])
    j_convert.main(["--pth", pth, "--infos", infos, "--out", out_j,
                    "--model_type", preset])
    got = load_model_npz(os.path.join(out_p, "model.npz"))
    want = load_model_npz(os.path.join(out_j, "model.npz"))
    assert _flat_bytes(got) == _flat_bytes(want)
    assert _flat_bytes(got) == _flat_bytes({"params": params,
                                            "state": state})
    infos_p, infos_j = (json.load(open(os.path.join(d, "infos.json")))
                        for d in (out_p, out_j))
    assert infos_p == infos_j
    assert sorted(infos_p) == ["converted_from", "epoch", "iter",
                               "model_config", "model_type", "vocab"]
    assert (infos_p["iter"], infos_p["model_type"]) == (60000, preset)
    mcfg = P.config_from_json(P.ModelConfig, infos_p["model_config"])
    assert (mcfg.use_bn, mcfg.gcn_bn, mcfg.use_gt_subg, mcfg.use_gpn) == \
        (cfg.use_bn, cfg.gcn_bn, cfg.use_gt_subg, cfg.use_gpn)

    legacy = LAYOUTS[layout][2]
    if legacy is not None:
        npz_p, npz_j = str(work / "port.npz"), str(work / "jax.npz")
        convert_ckpt.main([pth, npz_p, "--vocab-size", "40"] + legacy)
        j_convert.main([pth, npz_j, "--vocab-size", "40"] + legacy)
        assert _flat_bytes(load_model_npz(npz_p)) == \
            _flat_bytes(load_model_npz(npz_j)) == _flat_bytes(got)
    capsys.readouterr()


def _decode_common(man, ckpt, tag):
    return ["Sub_GC_Kar", "--checkpoint_path", ckpt, "--iter_tag", tag,
            "--bucket", "8", "--batch_images", "2",
            "--input_json", man["input_json"],
            "--input_label_h5", man["input_label_h5"],
            "--sg_dir", man["sg_dir"], "--mask_dir", man["mask_dir"]]


@pytest.mark.parametrize("layout", ["kar", "use_bn1", "use_bn2", "gt_subg"])
def test_both_test_clis_decode_the_converted_directory(data, layout):
    root, man, vocab = data
    _, work, pth, infos, _, _ = _reference(root, layout, vocab, seed=40)
    ckpt = str(work / "decode")
    convert_ckpt.main(["--pth", pth, "--infos", infos, "--out", ckpt,
                       "--model_type", "Sub_GC_Kar"])
    p = p_test_cli.main(_decode_common(man, ckpt, "port")
                        + ["--device", "cpu"])
    j = j_test_cli.main(_decode_common(man, ckpt, "jax"))
    pp, jp = (np.load(r["captions_path"], allow_pickle=True).tolist()
              for r in (p, j))
    assert len(pp) == len(jp) == 2
    for a, b in zip(pp, jp):
        assert a["image_id"] == b["image_id"]
        assert a["caption"] == b["caption"] and a["caption"]
        np.testing.assert_array_equal(a["sorted_subgraph_ind"],
                                      b["sorted_subgraph_ind"])
        np.testing.assert_allclose(a["subgraph_score"], b["subgraph_score"],
                                   rtol=0, atol=1e-5)


def test_full_gc_decodes_the_same_in_both_packages(data):
    root, _, vocab = data
    cfg, work, pth, infos, _, _ = _reference(root, "full_gc", vocab, seed=41)
    ckpt = str(work / "decode")
    convert_ckpt.main(["--pth", pth, "--infos", infos, "--out", ckpt,
                       "--model_type", "Full_GC_Kar"])
    blob = load_model_npz(os.path.join(ckpt, "model.npz"))
    jcfg = JC.build_configs("Full_GC_Kar", model=WIDTHS)[0]
    jp, js = (jax.tree_util.tree_map(jnp.asarray, blob[k])
              for k in ("params", "state"))
    tp, ts = (P.params_from_numpy(blob[k], "cpu") for k in ("params",
                                                            "state"))
    ex = cs.make_examples(cfg, 1, 1, seed=5)[0]
    ecfg = P.EvalConfig(beam_size=3)
    enc = P.encode_image(tp, ts, P.to_device(ex.graph, "cpu"), None, cfg,
                         ecfg)
    seq = P.beam_search(tp, enc.feats, cfg, ecfg).seq
    jg = JSceneGraph(*map(jnp.asarray, ex.graph))
    jenc = JS.encode_image(jp, js, jg, None, jcfg, JC.EvalConfig(beam_size=3))
    jseq = JB.beam_search(jp, jenc.feats, jcfg, JC.EvalConfig(beam_size=3)).seq
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))


def test_a_run_id_that_is_no_preset_writes_sub_gc_kar(data, capsys):
    root, _, vocab = data
    _, work, pth, infos, _, _ = _reference(root, "kar", vocab, seed=42)
    out_p, out_j = str(work / "noid_port"), str(work / "noid_jax")
    convert_ckpt.main(["--pth", pth, "--infos", infos, "--out", out_p])
    msg_p = capsys.readouterr().out
    j_convert.main(["--pth", pth, "--infos", infos, "--out", out_j])
    msg_j = capsys.readouterr().out
    note = ("[convert] reference opt.id 'topdown' is not a preset; writing "
            "model_type=Sub_GC_Kar (override with --model_type)")
    assert note in msg_p and note in msg_j
    for d in (out_p, out_j):
        with open(os.path.join(d, "infos.json")) as f:
            assert json.load(f)["model_type"] == "Sub_GC_Kar"
    with pytest.raises(SystemExit, match="--pth requires --infos"):
        convert_ckpt.main(["--pth", pth])
