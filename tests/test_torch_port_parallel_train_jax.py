"""The port's data-parallel train step (gloo ranks on the CPU) held against
the JAX package's step on its 8-device mesh (``tests/conftest.py``'s forced
host devices), at tiny widths, with dropout off on both sides (no
generator and ``drop_prob_lm=0``; JAX with no rng): the hoisted step twice
from iteration 0, for an sGPN config (Sub-GC), Full-GC with its GCN
BatchNorm synced across the ranks, and ``use_bn=1``.  One spawn of 2 ranks
runs all three; ``tests/test_torch_port_parallel_train.py`` holds 2 and 4
ranks against the port's single-process step on the same specs.

Tolerances: losses rtol 1e-5; parameters and running statistics rtol 2e-4
/ atol 1e-6 (JAX's sharded-vs-single tolerance, ``tests/test_train.py``),
except the leaves whose gradient is zero in exact arithmetic (the
attention's logit bias, the biases BatchNorm cancels), which Adam moves by
the sign of float noise; ``tests/test_torch_port_parallel_train.py`` holds
their gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subgc_tpu.config import ModelConfig as JModelConfig
from subgc_tpu.config import TrainConfig as JTrainConfig
from subgc_tpu.parallel import mesh as JM
from subgc_tpu.train import optim as JO
from subgc_tpu.train import step as JST
from subgc_tpu_torch.parallel import steps as PS
from .test_torch_port_parallel_train import CASES, _spec


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    specs = [_spec(c, False) for c in CASES]
    reports = PS.run_ranks(specs, ["cpu"] * 2,
                           str(tmp_path_factory.mktemp("ranks")))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = [PS.run_steps(s, "cpu") for s in specs]
    finally:
        torch.set_num_threads(n)
    return specs, reports, single


def _jax_mesh_run(spec):
    """The JAX package's step on its 8-device mesh (batch sharded, params
    replicated) from the spec's weights, no rng; returns (losses, params,
    state) as numpy."""
    jcfg = JModelConfig(**spec["cfg"])
    jtcfg = JTrainConfig(**spec["tcfg"])
    opt = JO.build_optimizer(jtcfg)
    step = JST.make_train_step(jcfg, jtcfg, opt, ss_active=False)
    mesh = JM.make_mesh()
    assert mesh.devices.size == 8
    params, state = spec["params"]
    ts = JST.init_train_state(JM.replicate(mesh, params),
                              JM.replicate(mesh, state), opt)
    z = jnp.zeros((), jnp.int32), jnp.zeros(())
    losses = []
    for b in spec["batches"]:
        ts, m = step(ts, JM.shard_leading_axis(mesh, b), None, *z)
        losses.append(float(m["loss"]))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return losses, to_np(ts.params), to_np(ts.model_state)


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_match_the_jax_mesh_step(ranks, case):
    """JAX's 8-device mesh step against the port's 2 ranks and its single
    process."""
    specs, reports, single = ranks
    i = list(CASES).index(case)
    losses, jparams, jstate = _jax_mesh_run(specs[i])
    want = {"params": jparams, "state": jstate,
            "metrics": single[i]["metrics"]}
    for got in (reports[0][i], single[i]):
        np.testing.assert_allclose([m["loss"] for m in got["metrics"]],
                                   losses, rtol=1e-5)
        assert PS.same_parameters(got, want) == []
    assert reports[0][i]["checksum"] == reports[1][i]["checksum"]
