"""The port's parity check (``python -m subgc_tpu_torch.cli.parity_eval``)
against the JAX package: a seeded reference-layout ``model-*.pth`` at
``ModelConfig()`` widths (the tool's model, as the JAX tool's; the vocab
is the dataset's), decoded by the JAX package's ``run_test_split`` from
``tools/convert_torch_ckpt.py``'s conversion of it, whose
``captions_*.npy`` the port's tool then matches caption for caption: its
``caption match`` line reads 100%.  On the CPU (``--device cpu``), two
test images at bucket 16.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke as cs
import subgc_tpu.config as JC
import subgc_tpu_torch as P
from subgc_tpu.data.dataset import EvalLoader as JEvalLoader
from subgc_tpu.data.synthetic import generate_dataset
from subgc_tpu.eval.runner import run_test_split as j_run_test_split
from subgc_tpu.eval.runner import save_predictions as j_save_predictions
from subgc_tpu_torch.cli import parity_eval
from tools.convert_torch_ckpt import torch_state_dict_to_params

from .test_torch_port_train import one_thread  # noqa: F401


def test_parity_eval_matches_the_jax_runner_on_converted_weights(
        tmp_path, capsys):
    man = generate_dataset(str(tmp_path / "d"), n_images=10, vocab_size=40,
                           n_subgraphs=6, seed=17)
    cfg = P.ModelConfig(vocab_size=40)
    pth, _, _, _ = cs.write_reference_checkpoint(str(tmp_path), cfg, {},
                                                 seed=6)
    paths = dict(input_json=man["input_json"],
                 input_label_h5=man["input_label_h5"],
                 sg_dir=man["sg_dir"], mask_dir=man["mask_dir"])
    jloader = JEvalLoader(JC.ModelConfig(), JC.DataConfig(**paths), bucket=16)
    jcfg = JC.ModelConfig(vocab_size=jloader.vocab_size,
                          seq_length=jloader.seq_length)
    sd = {k: v.numpy()
          for k, v in torch.load(pth, weights_only=True).items()}
    params, state = (jax.tree_util.tree_map(jnp.asarray, t)
                     for t in torch_state_dict_to_params(sd, jcfg))
    ecfg = JC.EvalConfig(beam_size=2, gpn_nms_thres=0.75, gpn_max_subg=10)
    jpreds, _, n_caps = j_run_test_split(params, state, jloader, jcfg, ecfg,
                                         jloader.vocab, num_images=2,
                                         verbose=False)
    ref = j_save_predictions(jpreds, str(tmp_path / "ref"), "60000")
    capsys.readouterr()
    flags = ["--ckpt", pth, "--ref_captions", ref, "--bucket", "16",
             "--num_images", "2", "--device", "cpu"] + [
        x for k, v in paths.items() for x in (f"--{k}", v)]
    res = parity_eval.main(flags)
    out = capsys.readouterr().out
    assert res["total"] == n_caps > 2 and res["match"] == n_caps
    assert f"caption match: {n_caps}/{n_caps} (100.00%)" in out
    assert len({c for p in res["preds"] for c in p["caption"]}) > 1
    # the captions differ from a reference of other weights: the line can
    # read less than 100%
    other = [dict(p, caption=[c + " x" for c in p["caption"]])
             for p in jpreds]
    assert parity_eval.caption_match(res["preds"], other) == (0, n_caps)


def test_parity_eval_decodes_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parity_eval.main(["--ckpt", "x.pth", "--input_json", "j",
                          "--input_label_h5", "h", "--sg_dir", "s",
                          "--mask_dir", "m"])
