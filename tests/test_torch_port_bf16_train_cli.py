"""Training in the port's bfloat16 chain end to end, on the JAX package's
synthetic data (this needs h5py): 40 bf16 train steps over float32
parameters and Adam state lower the loss, as ``tests/test_bf16.py``
requires of the JAX package, and ``cli/train.py --compute_dtype bfloat16
--bf16_lstm_gates 1 --bf16_residuals 1`` writes a checkpoint whose
``model_config`` records the chain, which ``cli/test.py`` then decodes in
bf16.  The gradients against ``jax.value_and_grad`` are
``tests/test_torch_port_bf16_train.py``.
"""
import json
import os

import numpy as np
import pytest
import torch

from subgc_tpu.data.synthetic import generate_dataset
from subgc_tpu_torch.cli import test as p_test_cli
from subgc_tpu_torch.cli import train as p_cli
from subgc_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from subgc_tpu_torch.data.dataset import TrainLoader
from subgc_tpu_torch.eval import runner
from subgc_tpu_torch.models.params import init_params_numpy, params_from_numpy
from subgc_tpu_torch.train.optim import tree_leaves
from subgc_tpu_torch.train.step import (batch_to_device, init_train_state,
                                        make_train_step)

from .test_torch_port_train import one_thread  # noqa: F401
from .test_torch_port_train_cli import (_data_flags, _dim_flags,
                                        data)  # noqa: F401


def _tiny_data(tmp_path):
    return generate_dataset(str(tmp_path / "d"), n_images=8, seed=3,
                            vocab_size=20, learnable=True)


@pytest.mark.parametrize("gates", [False, True])
def test_bf16_training_loss_decreases(tmp_path, gates):
    """40 bf16 steps over float32 parameters and Adam state lower the loss,
    the bar ``tests/test_bf16.py`` sets the JAX package (same data, widths
    and schedule)."""
    man = _tiny_data(tmp_path)
    mcfg = ModelConfig(vocab_size=man["vocab_size"], rnn_size=32,
                       input_encoding_size=24, att_hid_size=16, gcn_dim=16,
                       fc_feat_size=24, att_feat_size=man["feat_dim"],
                       embed_dim=12, num_obj_classes=man["n_obj_classes"],
                       num_rel_classes=man["n_rel_classes"],
                       compute_dtype="bfloat16", bf16_lstm_gates=gates)
    tcfg = TrainConfig(batch_size=4, warmup_n=10, learning_rate=2e-3)
    loader = TrainLoader(mcfg, tcfg, DataConfig(
        input_json=man["input_json"], input_label_h5=man["input_label_h5"],
        sg_dir=man["sg_dir"], mask_dir=man["mask_dir"]))
    params, state = init_params_numpy(mcfg, seed=0)
    ts = init_train_state(params_from_numpy(params, "cpu", True),
                          params_from_numpy(state, "cpu"), tcfg)
    step = make_train_step(mcfg, tcfg)
    gen = torch.Generator().manual_seed(1)
    losses = []
    for _ in range(40):
        batch, _, _ = loader.get_batch("train")
        ts, m = step(ts, batch_to_device(batch, "cpu"), gen, 0, 0.0)
        losses.append(float(m["loss"]))
    assert all(t.dtype == torch.float32 for t in tree_leaves(ts.params))
    assert all(t.dtype == torch.float32
               for t in tree_leaves(ts.opt_state.mu))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < losses[0] - 0.3, losses[::8]


def test_cli_trains_in_bf16_and_test_cli_decodes_in_bf16(data, monkeypatch):
    """``--compute_dtype bfloat16 --bf16_lstm_gates 1 --bf16_residuals 1``
    round-trip through the checkpoint's ``model_config``; the test CLI
    reads it and decodes in bf16."""
    root, man = data
    out = str(root / "port_bf16_run")
    res = p_cli.main(["Sub_GC_Kar", "--checkpoint_path", out, "--device",
                      "cpu", "--batch_size", "2", "--max_iters", "2",
                      "--val_images_use", "2", "--compute_dtype", "bfloat16",
                      "--bf16_lstm_gates", "1", "--bf16_residuals", "1"]
                     + _dim_flags() + _data_flags(man))
    assert res["iter"] == 2
    with open(os.path.join(out, "infos.json")) as f:
        mc = json.loads(json.load(f)["model_config"])
    assert (mc["compute_dtype"], mc["bf16_lstm_gates"],
            mc["bf16_residuals"]) == ("bfloat16", True, True)
    with open(os.path.join(out, "histories.json")) as f:
        assert np.isfinite(json.load(f)["val_loss_history"]["2"])

    seen = []
    real = runner.run_test_split

    def spy(params, state, loader, cfg, *a, **k):
        seen.append((cfg.compute_dtype, cfg.bf16_lstm_gates))
        return real(params, state, loader, cfg, *a, **k)

    monkeypatch.setattr(runner, "run_test_split", spy)
    caps = p_test_cli.main(["Sub_GC_Kar", "--checkpoint_path", out,
                            "--device", "cpu", "--bucket", "8",
                            "--batch_images", "2", "--num_images", "2"]
                           + _data_flags(man)[:8])
    assert seen == [("bfloat16", True)]
    preds = np.load(caps["captions_path"], allow_pickle=True).tolist()
    assert len(preds) == 2 and all(p["caption"] for p in preds)
