"""Diverse beam groups in the port's bf16 chain and test CLI against the
JAX package.

Both packages' ``run_test_split`` in bf16 at ``beam_size`` 4, ``group_size``
2: identical keep sets, sGPN scores within atol 2e-2 and token agreement
>= 0.95 (``test_torch_port_bf16_slice.py``'s rule); then ``cli/test.py
--group_size 2 --beam_size 4`` against the JAX CLI's captions (float32:
equal), and the CLI's divisibility check.
"""
import jax
import numpy as np
import pytest

import subgc_tpu.config as JC
from subgc_tpu.cli import test as j_cli
from subgc_tpu.data.dataset import EvalLoader as JEvalLoader
from subgc_tpu.eval.runner import run_test_split as j_run_test_split
from subgc_tpu.models.params import init_params as j_init_params
import subgc_tpu_torch as P
from subgc_tpu_torch.cli import test as p_cli

from .test_torch_port_bf16_slice import _agreement, synth  # noqa: F401
from .test_torch_port_cli import run  # noqa: F401
from .test_torch_port_slice import _widths
from .test_torch_port_train import one_thread  # noqa: F401


def test_diverse_run_test_split_bf16_matches_jax(synth, tiny_cfg,  # noqa: F811
                                                 one_thread):  # noqa: F811
    over = dict(model={**_widths(tiny_cfg), "compute_dtype": "bfloat16"},
                eval=dict(beam_size=4, group_size=2, diversity_lambda=0.5))
    jcfg, jecfg, _ = JC.build_configs("Sub_GC_Kar", **over)
    cfg, ecfg, _ = P.build_configs("Sub_GC_Kar", **over)
    paths = dict(input_json=synth["input_json"],
                 input_label_h5=synth["input_label_h5"],
                 sg_dir=synth["sg_dir"], mask_dir=synth["mask_dir"])
    jloader = JEvalLoader(jcfg, JC.DataConfig(**paths), bucket=16)
    loader = P.EvalLoader(cfg, P.DataConfig(**paths), bucket=16)
    params, state = j_init_params(jax.random.PRNGKey(1), jcfg,
                                  n_obj_names=30, n_pred_names=10)
    jpreds, _, _ = j_run_test_split(params, state, jloader, jcfg, jecfg,
                                    jloader.vocab, verbose=False,
                                    batch_images=3, keep_tokens=True,
                                    num_images=6)
    tp = P.params_from_numpy(jax.tree_util.tree_map(np.array, params), "cpu")
    preds, _, _ = P.run_test_split(tp, state, loader, cfg, ecfg,
                                   loader.vocab, verbose=False,
                                   batch_images=3, keep_tokens=True,
                                   device="cpu", num_images=6)
    assert _agreement(preds, jpreds) >= 0.95


def test_cli_diverse_groups_match_jax(run):  # noqa: F811
    ckpt, common = run
    flags = ["--group_size", "2", "--beam_size", "4",
             "--diversity_lambda", "0.5"]
    j = j_cli.main(["Sub_GC_Kar", "--iter_tag", "div_jax"] + flags + common)
    p = p_cli.main(["Sub_GC_Kar", "--iter_tag", "div_torch",
                    "--device", "cpu"] + flags + common)
    jp = np.load(j["captions_path"], allow_pickle=True).tolist()
    pp = np.load(p["captions_path"], allow_pickle=True).tolist()
    assert len(pp) == len(jp) == 2
    for a, b in zip(pp, jp):
        assert a["image_id"] == b["image_id"]
        assert a["caption"] == b["caption"]
        np.testing.assert_array_equal(a["sorted_subgraph_ind"],
                                      b["sorted_subgraph_ind"])
    with pytest.raises(SystemExit, match="divisible"):
        p_cli.main(["Sub_GC_Kar", "--device", "cpu", "--group_size", "3",
                    "--beam_size", "4"] + common)
