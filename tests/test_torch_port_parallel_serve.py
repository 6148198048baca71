"""``--shard_fanout`` serving in the port: ``ModelService(mesh=...)`` keeps
one model copy per mesh device and splits each dispatch's sub-graph rows
over them (``eval/runner.py``'s sub-graph axis, one thread per device), on
the CPU with meshes whose entries are all the CPU.

Held against the port's unsharded service (captions equal, scores rtol
1e-6) and against the JAX package's ``ModelService(mesh=...)`` over its
8-device mesh, the counterpart of ``tests/test_serve.py::
test_fanout_sharded_service`` (captions equal, scores atol 1e-5, as
``tests/test_torch_port_serve.py`` holds the float32 service); ``device``
or ``devices`` with ``mesh`` raise, as in JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subgc_tpu.cli import serve as JS
from subgc_tpu.config import EvalConfig as JEvalConfig
from subgc_tpu.config import ModelConfig as JModelConfig
from subgc_tpu.parallel import mesh as JM
from subgc_tpu_torch.cli import serve as PS
from subgc_tpu_torch.config import EvalConfig, ModelConfig
from subgc_tpu_torch.parallel.mesh import make_mesh

from .test_torch_port_serve import (EVAL, VOCAB, WIDTHS, image,  # noqa
                                    pinned_flags, weights)
from .test_torch_port_train import one_thread  # noqa: F401

KW = dict(default_dtype="float32", batch_images=2, microbatch_wait_ms=5.0)


def cpu_mesh(n):
    return make_mesh(devices=[torch.device("cpu")] * n)


@pytest.mark.parametrize("beam", [2, 1])
@pytest.mark.parametrize("n", [2, 3])
def test_fanout_sharded_service_matches_unsharded_and_jax(beam, n,
                                                          pinned_flags):
    params, state = weights()
    ecfg = dict(EVAL, beam_size=beam)
    sharded = PS.ModelService(params, state, ModelConfig(**WIDTHS),
                              EvalConfig(**ecfg), VOCAB, mesh=cpu_mesh(n),
                              **KW)
    single = PS.ModelService(params, state, ModelConfig(**WIDTHS),
                             EvalConfig(**ecfg), VOCAB, device="cpu", **KW)
    jmesh = JM.make_mesh()
    jsvc = JS.ModelService(jax.tree_util.tree_map(jnp.asarray, params),
                           jax.tree_util.tree_map(jnp.asarray, state),
                           JModelConfig(**WIDTHS), JEvalConfig(**ecfg),
                           VOCAB, mesh=jmesh, **KW)
    assert sharded.describe()["fanout_devices"] == n
    assert sharded.describe()["replicas"] == 1
    assert single.describe()["fanout_devices"] == 1
    rng = np.random.RandomState(13)
    imgs = [image(rng, i, with_subgraphs=i != 1) for i in range(3)]
    got = [sharded([img])[0] for img in imgs]
    want = [single([img])[0] for img in imgs]
    jwant = [jsvc([img])[0] for img in imgs]
    for g, w, j in zip(got, want, jwant):
        assert g["captions"] == w["captions"] == j["captions"]
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=1e-6)
        np.testing.assert_allclose(g["scores"], j["scores"], rtol=0,
                                   atol=1e-5)
    # a request of several images shares one sharded dispatch
    assert sharded(imgs[:2]) == single(imgs[:2])


def test_bf16_fanout_equals_the_unsharded_bf16_service(pinned_flags):
    """The default dtype (bf16, image-shared attention): a shard of the
    rows that starts inside an image attends over that image's streams."""
    params, state = weights()
    kw = dict(KW, default_dtype="bfloat16")
    sharded = PS.ModelService(params, state, ModelConfig(**WIDTHS),
                              EvalConfig(**EVAL), VOCAB, mesh=cpu_mesh(3),
                              **kw)
    single = PS.ModelService(params, state, ModelConfig(**WIDTHS),
                             EvalConfig(**EVAL), VOCAB, device="cpu", **kw)
    rng = np.random.RandomState(3)
    imgs = [image(rng, i) for i in range(2)]
    assert sharded(imgs) == single(imgs)


def test_mesh_excludes_device_and_devices(pinned_flags):
    params, state = weights()
    args = (params, state, ModelConfig(**WIDTHS), EvalConfig(**EVAL), VOCAB)
    mesh = cpu_mesh(2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        PS.ModelService(*args, devices=["cpu", "cpu"], mesh=mesh, **KW)
    with pytest.raises(ValueError, match="mutually exclusive"):
        PS.ModelService(*args, device="cpu", mesh=mesh, **KW)
    with pytest.raises(ValueError, match="mutually exclusive"):
        PS.build_service(*args, device="cpu", mesh=mesh)
