"""The port's Sub_GC_Kar test path end to end against the JAX package, plus
the port's import hygiene and its refusal to fall back to the CPU.

On the same synthetic dataset and the same weights, both packages'
``run_test_split`` must give identical captions and sub-graph orders, and
sGPN scores within rtol 1e-5.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import subgc_tpu.config as JC
from subgc_tpu.data.dataset import EvalLoader as JEvalLoader
from subgc_tpu.data.synthetic import generate_dataset
from subgc_tpu.eval.runner import run_test_split as j_run_test_split
from subgc_tpu.models.params import init_params as j_init_params
import subgc_tpu_torch as P
from subgc_tpu_torch.eval.rerank import find_nn_images

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_slice")
    return generate_dataset(str(root), n_images=20, vocab_size=50,
                            feat_dim=80, n_subgraphs=12, seed=3)


def _widths(cfg):
    """The tiny model widths of ``cfg`` as a build_configs override."""
    return {f: getattr(cfg, f) for f in
            ("vocab_size", "rnn_size", "input_encoding_size", "att_hid_size",
             "gcn_dim", "fc_feat_size", "att_feat_size", "embed_dim",
             "num_obj_classes", "num_rel_classes")}


def test_run_test_split_matches_jax(synth, tiny_cfg, tmp_path):
    over = dict(model=_widths(tiny_cfg))
    jcfg, jecfg, _ = JC.build_configs("Sub_GC_Kar", **over)
    cfg, ecfg, _ = P.build_configs("Sub_GC_Kar", **over)
    assert (ecfg.beam_size, ecfg.gpn_nms_thres, ecfg.gpn_max_subg) == \
        (2, 0.75, 10)
    paths = dict(input_json=synth["input_json"],
                 input_label_h5=synth["input_label_h5"],
                 sg_dir=synth["sg_dir"], mask_dir=synth["mask_dir"])
    jloader = JEvalLoader(jcfg, JC.DataConfig(**paths), bucket=16)
    loader = P.EvalLoader(cfg, P.DataConfig(**paths), bucket=16)
    params, state = j_init_params(jax.random.PRNGKey(1), jcfg,
                                  n_obj_names=30, n_pred_names=10)
    jpreds, _, jn = j_run_test_split(params, state, jloader, jcfg, jecfg,
                                     jloader.vocab, verbose=False,
                                     batch_images=3)
    tp = P.params_from_numpy(jax.tree_util.tree_map(np.array, params), "cpu")
    preds, _, n = P.run_test_split(tp, state, loader, cfg, ecfg, loader.vocab,
                                   verbose=False, batch_images=3,
                                   device="cpu")
    assert n == jn and len(preds) == len(jpreds) == 4
    for p, j in zip(preds, jpreds):
        assert p["image_id"] == j["image_id"]
        assert p["caption"] == j["caption"]
        np.testing.assert_array_equal(p["sorted_subgraph_ind"],
                                      j["sorted_subgraph_ind"])
        np.testing.assert_allclose(p["subgraph_score"], j["subgraph_score"],
                                   rtol=1e-5)
    path = P.save_predictions(preds, str(tmp_path), "0")
    assert np.load(path, allow_pickle=True).tolist()[0]["caption"] == \
        preds[0]["caption"]


@pytest.mark.parametrize("name", ["ModelConfig", "EvalConfig", "TrainConfig",
                                  "DataConfig"])
def test_configs_match_jax_field_for_field(name):
    """Same fields and defaults, so infos.json loads in either package."""
    jcls, cls = getattr(JC, name), getattr(P, name)
    assert dataclasses.asdict(cls()) == dataclasses.asdict(jcls())
    assert P.config_from_json(cls, JC.config_to_json(jcls())) == cls()


def test_test_presets_match_jax():
    assert P.TEST_PRESETS == JC.TEST_PRESETS
    for name in P.TEST_PRESETS:
        assert [dataclasses.asdict(c) for c in P.build_configs(name)] == \
            [dataclasses.asdict(c) for c in JC.build_configs(name)]


def test_port_imports_neither_jax_nor_the_jax_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None          # any import of jax now fails
        import subgc_tpu_torch
        for m in pkgutil.walk_packages(subgc_tpu_torch.__path__,
                                       "subgc_tpu_torch."):
            importlib.import_module(m.name)
        bad = [k for k in sys.modules
               if k.split(".")[0] in ("subgc_tpu", "h5py", "scipy")]
        assert not bad, bad
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stdout + proc.stderr


@pytest.mark.parametrize("entry", ["init_params", "params_from_numpy",
                                   "run_test_split", "find_nn_images"])
def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = P.ModelConfig(vocab_size=20, rnn_size=16, input_encoding_size=8,
                        att_hid_size=8, gcn_dim=8, fc_feat_size=8,
                        att_feat_size=16, embed_dim=4, num_obj_classes=5,
                        num_rel_classes=3)
    calls = {
        "init_params": lambda: P.init_params(cfg),
        "params_from_numpy": lambda: P.params_from_numpy({"w": np.ones(2)}),
        "run_test_split": lambda: P.run_test_split(
            {}, {}, None, cfg, P.EvalConfig(beam_size=2), {}),
        "find_nn_images": lambda: find_nn_images(np.ones((2, 3), "f"),
                                                 np.ones((4, 3), "f")),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


@pytest.mark.parametrize("preset", sorted(P.TEST_PRESETS))
def test_every_test_preset_decodes_on_cpu(tiny_cfg, preset):
    """Each of the eight test presets through the port's entry points at
    tiny widths, on ``chip_smoke.py``'s synthetic images: Full_GC_Kar per
    image through encode_image + beam_search, the others through
    run_test_split (the SCT presets on region-set images, no NMS)."""
    import chip_smoke as cs
    over = dict(model=_widths(tiny_cfg),
                eval=dict(max_subgraph_bucket=16))
    cfg, ecfg, _ = P.build_configs(preset, **over)
    params, state = P.init_params(cfg, seed=3, device="cpu")
    vocab = {str(i): f"w{i}" for i in range(1, cfg.vocab_size + 1)}
    if not cfg.use_gpn:
        examples = cs.make_examples(cfg, 2, 1, seed=4)
        seqs = cs.decode_fullgc(params, state, examples, cfg, ecfg, "cpu")
        assert seqs.shape == (2, cfg.seq_length)
        return
    if ecfg.sct:
        examples = cs.make_sct_examples(cfg, 3, 16, seed=4,
                                        gt=ecfg.use_gt_subg)
    else:
        examples = cs.make_examples(cfg, 3, 16, seed=4)
    preds, _, n = P.run_test_split(params, state, cs.MemoryLoader(examples),
                                   cfg, ecfg, vocab, verbose=False,
                                   batch_images=2, device="cpu")
    assert len(preds) == 3 and n == sum(len(p["caption"]) for p in preds)
    for p, ex in zip(preds, examples):
        assert np.isfinite(p["subgraph_score"]).all()
        if ecfg.sct:
            np.testing.assert_array_equal(p["sorted_subgraph_ind"],
                                          np.arange(ex.n_subgraphs))
        else:
            assert 1 <= len(p["caption"]) <= ecfg.gpn_max_subg


def test_verbose_beam_prints_as_jax(synth, tiny_cfg, capsys):
    """verbose_beam: one random kept sub-graph's beams per image, drawn
    from RandomState(2019) as the JAX runner draws them; same text."""
    over = dict(model=_widths(tiny_cfg), eval=dict(verbose_beam=1))
    jcfg, jecfg, _ = JC.build_configs("Sub_GC_Kar", **over)
    cfg, ecfg, _ = P.build_configs("Sub_GC_Kar", **over)
    paths = dict(input_json=synth["input_json"],
                 input_label_h5=synth["input_label_h5"],
                 sg_dir=synth["sg_dir"], mask_dir=synth["mask_dir"])
    jloader = JEvalLoader(jcfg, JC.DataConfig(**paths), bucket=16)
    loader = P.EvalLoader(cfg, P.DataConfig(**paths), bucket=16)
    params, state = j_init_params(jax.random.PRNGKey(6), jcfg,
                                  n_obj_names=30, n_pred_names=10)
    j_run_test_split(params, state, jloader, jcfg, jecfg, jloader.vocab,
                     verbose=False, batch_images=2)
    jout = capsys.readouterr().out
    tp = P.params_from_numpy(jax.tree_util.tree_map(np.array, params), "cpu")
    P.run_test_split(tp, state, loader, cfg, ecfg, loader.vocab,
                     verbose=False, batch_images=2, device="cpu")
    out = capsys.readouterr().out
    assert out.count("beam search sentences of image") == 4
    assert out == jout
