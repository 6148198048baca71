"""The port's four other optimizers (``adamw``, ``sgd``, ``rmsprop``,
``adagrad``) and Adam with weight decay, held against the JAX package's
optax chains (``subgc_tpu/train/optim.py::build_optimizer``) on identical
gradients over 5 steps, one of them clipped (global norm above 10) and one
parameter without a gradient: params rtol 1e-6 (atol 1e-5 x lr, the
bias-correction powers of Adam's, which jitted optax rounds a few ulps
apart), moments rtol 1e-6 plus 1e-6 of the leaf's largest magnitude (the
two packages' global norms differ in the last bit, so the clipped step's
gradients do; a later ``g + decay * t`` that cancels to a small element
keeps its terms' rounding); and the checkpoint round trip of each
optimizer's state: kind, count and moments back exactly, a resume under
another ``optim`` refused, an Adam file of an earlier version (no
``kind``) still read.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from subgc_tpu.config import TrainConfig as JTrainConfig
from subgc_tpu.train import optim as JO
from subgc_tpu_torch.config import TrainConfig
from subgc_tpu_torch.models.params import _flatten, params_from_numpy
from subgc_tpu_torch.train import checkpoint as C
from subgc_tpu_torch.train import optim as O

from .test_torch_port_optim import _set_lr
from .test_torch_port_train import flat_paths

# each port moment and the optax state field that holds it
OPTAX_FIELD = {"mu": "mu", "nu": "nu", "trace": "trace",
               "sum_of_squares": "sum_of_squares"}
CASES = {"adamw": dict(optim="adamw"), "sgd": dict(optim="sgd"),
         "rmsprop": dict(optim="rmsprop"), "adagrad": dict(optim="adagrad"),
         "adam_wd": dict(optim="adam", weight_decay=0.01),
         "rmsprop_cfg": dict(optim="rmsprop", optim_alpha=0.8,
                             optim_epsilon=1e-6)}


def _field(state, name):
    """The optax state field ``name`` (a tree), wherever it nests."""
    if hasattr(state, "_fields") and name in state._fields:
        return getattr(state, name)
    children = (state if isinstance(state, tuple) else
                [getattr(state, "inner_state", None)])
    for c in children:
        if c is not None and (found := _field(c, name)) is not None:
            return found
    return None


def _params(rng):
    return {"a": {"w": rng.randn(7, 5).astype("f"),
                  "b": rng.randn(5).astype("f")},
            "l": [rng.randn(3, 4).astype("f"), rng.randn(6).astype("f")]}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_optax_over_five_steps(case):
    rng = np.random.RandomState(1)
    params = _params(rng)
    kw = dict(CASES[case], learning_rate=1e-2)
    tcfg, jtcfg = TrainConfig(**kw), JTrainConfig(**kw)
    opt = JO.build_optimizer(jtcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = opt.init(jp)
    tp = params_from_numpy(params, "cpu", requires_grad=True)
    tstate = O.init_opt_state(tp, tcfg)
    assert tstate.kind == tcfg.optim and sorted(tstate.moments) == \
        sorted(O.MOMENTS[tcfg.optim])
    paths = list(flat_paths(params))
    norms = []
    for step, (scale, lr) in enumerate([(0.1, 1e-2), (30.0, 5e-3),
                                        (0.5, 2e-3), (1.0, 2e-3),
                                        (0.2, 1e-3)]):
        grads = {p: (rng.randn(*v.shape) * scale).astype("f")
                 for p, v in flat_paths(params).items()}
        grads[("l", 1)] = np.zeros_like(grads[("l", 1)])
        jg = jax.tree_util.tree_map(jnp.asarray, {
            "a": {"w": grads[("a", "w")], "b": grads[("a", "b")]},
            "l": [grads[("l", 0)], grads[("l", 1)]]})
        jstate = _set_lr(jstate, jnp.float32(lr))
        upd, jstate = opt.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tg = [None if p == ("l", 1) else torch.from_numpy(grads[p])
              for p in paths]
        tstate, norm = O.apply_update(tp, tg, tstate, lr, tcfg)
        norms.append(norm.item())
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(jg)),
                                   rtol=1e-6)
        checks = [("params", tp, jp, None)] + [
            (k, v, _field(jstate, OPTAX_FIELD[k]), 1e-6)
            for k, v in tstate.moments.items()]
        for name, got, want, scale in checks:
            g, w = flat_paths(got), flat_paths(want)
            for p in paths:
                atol = (1e-5 * lr if scale is None
                        else scale * np.abs(w[p]).max())
                np.testing.assert_allclose(g[p], w[p], rtol=1e-6, atol=atol,
                                           err_msg=f"{name} {p} step {step}")
        assert tstate.count == step + 1
    assert [n >= 10.0 for n in norms] == [False, True, False, False, False]
    # the parameter without a gradient moved only by weight decay
    moved = not np.array_equal(flat_paths(tp)[("l", 1)], params["l"][1])
    assert moved == (case in ("adamw", "adam_wd"))


def test_global_norm_as_accurate_as_optax_at_full_width():
    """The clip's norm over a leaf the size of the logit weight (9.5M
    float32): torch's CPU norm kernels sum the squares one after another
    and came out 2.9e-4 relative off; the port's ``global_norm`` agrees
    with optax's within 1e-6."""
    rng = np.random.RandomState(0)
    leaves = [(rng.randn(1000, 9488) * 1e-2).astype("f"),
              rng.randn(9488).astype("f"), rng.randn(3, 7).astype("f")]
    want = float(optax.global_norm([jnp.asarray(x) for x in leaves]))
    exact = np.sqrt(sum(float((x.astype("d") ** 2).sum()) for x in leaves))
    got = O.global_norm([torch.from_numpy(x) for x in leaves]).item()
    np.testing.assert_allclose(want, exact, rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optim"):
        O.init_opt_state({"w": torch.zeros(2)}, TrainConfig(optim="lion"))
    st = O.init_opt_state({"w": torch.zeros(2)}, TrainConfig(optim="sgd"))
    with pytest.raises(ValueError, match="optimizer state is 'sgd'"):
        O.apply_update({"w": torch.zeros(2)}, [None], st, 1e-3,
                       TrainConfig(optim="adam"))


@pytest.mark.parametrize("optim", sorted(O.MOMENTS))
def test_optimizer_state_checkpoint_round_trip(optim, tmp_path):
    rng = np.random.RandomState(2)
    params = _params(rng)
    tcfg = TrainConfig(optim=optim)
    tp = params_from_numpy(params, "cpu", requires_grad=True)
    st = O.init_opt_state(tp, tcfg)
    for _ in range(2):
        st, _ = O.apply_update(tp, [torch.from_numpy(
            rng.randn(*v.shape).astype("f")) for v in flat_paths(params)
            .values()], st, 1e-3, tcfg)
    C.save_checkpoint(str(tmp_path), tp, {}, st, {"iter": 2}, {})
    with np.load(os.path.join(tmp_path, "optimizer.npz")) as z:
        assert str(z["kind"]) == optim
    _, _, back, infos, _ = C.load_checkpoint(
        str(tmp_path), params_template=flat_params(tp), optim=optim)
    assert infos == {"iter": 2}
    assert (back.kind, back.count) == (optim, 2)
    assert sorted(back.moments) == sorted(st.moments)
    for k in st.moments:
        g, w = flat_paths(back.moments[k]), flat_paths(st.moments[k])
        assert sorted(g) == sorted(w)
        for p in w:
            np.testing.assert_array_equal(g[p], w[p], err_msg=f"{k} {p}")
    other = "sgd" if optim != "sgd" else "adam"
    with pytest.raises(ValueError, match=f"holds '{optim}'"):
        C.load_checkpoint(str(tmp_path), params_template=flat_params(tp),
                          optim=other)


def test_adam_file_without_kind_still_loads(tmp_path):
    """An ``optimizer.npz`` of an earlier version of the port: ``count``
    and the moments, no ``kind``."""
    rng = np.random.RandomState(3)
    params = _params(rng)
    mu = jax.tree_util.tree_map(lambda v: v * 1, params)
    flat = _flatten({"mu": mu, "nu": jax.tree_util.tree_map(
        lambda v: v * 2, params)})
    np.savez(os.path.join(tmp_path, "optimizer.npz"), count=np.asarray(7),
             **flat)
    C.save_checkpoint(str(tmp_path), params, {}, None, {}, {})
    _, _, back, _, _ = C.load_checkpoint(str(tmp_path),
                                         params_template=params)
    assert (back.kind, back.count) == ("adam", 7)
    np.testing.assert_array_equal(back.nu["a"]["w"], 2 * params["a"]["w"])
    with pytest.raises(ValueError, match="holds 'adam'"):
        C.load_checkpoint(str(tmp_path), params_template=params,
                          optim="rmsprop")


def flat_params(tp):
    from subgc_tpu_torch.models.params import params_to_numpy
    return params_to_numpy(tp)
