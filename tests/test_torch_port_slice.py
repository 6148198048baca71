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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_slice")
    return generate_dataset(str(root), n_images=20, vocab_size=50,
                            feat_dim=80, n_subgraphs=12, seed=3)


def test_run_test_split_matches_jax(synth, tiny_cfg, tmp_path):
    over = dict(model={f: getattr(tiny_cfg, f) for f in
                       ("vocab_size", "rnn_size", "input_encoding_size",
                        "att_hid_size", "gcn_dim", "fc_feat_size",
                        "att_feat_size", "embed_dim", "num_obj_classes",
                        "num_rel_classes")})
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
               if k.split(".")[0] in ("subgc_tpu", "h5py")]
        assert not bad, bad
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stdout + proc.stderr


@pytest.mark.parametrize("entry", ["init_params", "params_from_numpy",
                                   "run_test_split"])
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
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
