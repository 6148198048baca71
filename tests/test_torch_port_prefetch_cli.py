"""The port's train CLI, batches prefetched on a producer thread and
sampled by the C++ sampler, against the JAX CLI from one JAX checkpoint
with dropout off: the losses of 3 steps within rtol 1e-4 and the saved
params within atol 1e-5 (``tests/test_torch_port_optim.py``'s bars for
three steps), and the ``data`` / ``step`` phase reports of both.

The preset is Full_GC_Kar: it has no sGPN, whose hidden layer drops out at
a fixed 0.5 (the reference's) from each package's own generator, and
``--drop_prob_lm 0`` turns off the rest.  Neither run makes a val pass
inside the 3 steps: the val batches draw from the loader's numpy stream,
whose interleave with the producer thread's train draws depends on timing
in both packages; the one val pass after step 3 is left out of the
comparison.
"""
import json
import os

import numpy as np

import subgc_tpu.config as JC
from subgc_tpu.cli import train as j_cli
from subgc_tpu.train import checkpoint as JCK
from subgc_tpu.train.optim import build_optimizer
from subgc_tpu_torch.cli import train as p_cli
from subgc_tpu_torch.config import ModelConfig
from subgc_tpu_torch.models.params import init_params_numpy

from .test_torch_port_prefetch import _train_flags
from .test_torch_port_train import flat_paths
from .test_torch_port_train_cli import DIMS, data  # noqa: F401


def test_prefetched_train_cli_matches_jax_cli(data, capsys):  # noqa: F811
    root, man = data
    mcfg, _, _ = JC.build_configs("Full_GC_Kar", mode="train",
                                  model=dict(DIMS))
    mcfg = mcfg.replace(vocab_size=man["vocab_size"],
                        seq_length=man["seq_length"])
    params, state = init_params_numpy(
        ModelConfig(**{f: getattr(mcfg, f)
                       for f in ModelConfig.__dataclass_fields__}), seed=9,
        n_obj_names=man["n_obj_classes"], n_pred_names=man["n_rel_classes"])
    start = str(root / "prefetch_start")
    JCK.save_checkpoint(start, params, state,
                        build_optimizer(JC.TrainConfig()).init(params),
                        {"iter": 0, "epoch": 0}, {})
    common = ["--start_from", start, "--drop_prob_lm", "0"]
    out = {}
    for name, cli, more in (("j", j_cli, ["--n_devices", "1"]),
                            ("p", p_cli, ["--device", "cpu"])):
        out[name] = str(root / f"prefetch_{name}")
        cli.main(_train_flags(man, out[name], common + more,
                              preset="Full_GC_Kar"))
    log = capsys.readouterr().out
    assert log.count("data:") == 2 and log.count("step:") == 2
    hist = {}
    for name in out:
        with open(os.path.join(out[name], "histories.json")) as f:
            hist[name] = json.load(f)["loss_history"]
    assert sorted(hist["p"], key=int) == sorted(hist["j"], key=int) == \
        ["1", "2", "3"]
    np.testing.assert_allclose([hist["p"][k] for k in ("1", "2", "3")],
                               [hist["j"][k] for k in ("1", "2", "3")],
                               rtol=1e-4)
    jp = flat_paths(JCK.load_checkpoint(out["j"])[0])
    pp = flat_paths(JCK.load_checkpoint(out["p"])[0])
    assert sorted(pp) == sorted(jp)
    for k in jp:
        np.testing.assert_allclose(pp[k], jp[k], rtol=0, atol=1e-5,
                                   err_msg=str(k))
    moved = [k for k in jp if not np.array_equal(
        jp[k], flat_paths(params)[k])]
    assert ("decoder", "logit", "w") in moved and not mcfg.use_gpn
