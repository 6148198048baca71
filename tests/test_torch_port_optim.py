"""The port's optimizer, schedules and train step held against the JAX
package's: ``learning_rate`` and ``ss_prob`` exactly equal over a grid of
(iteration, epoch); the clipped Adam update against optax's chain
(``clip_by_global_norm``, ``add_decayed_weights``, ``adam``) on identical
gradients (params and moments within rtol 1e-6); three ``make_train_step``
steps from one JAX checkpoint against the JAX step (losses rtol 1e-4,
params atol 1e-5, dropout off on both sides); and a 30-step run on one
synthetic batch that lowers the loss.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from subgc_tpu.config import ModelConfig as JModelConfig
from subgc_tpu.config import TrainConfig as JTrainConfig
from subgc_tpu.data.synthetic import synthetic_train_batch as j_batch
from subgc_tpu.train import optim as JO
from subgc_tpu.train import step as JST
from subgc_tpu.train.checkpoint import save_checkpoint as j_save
from subgc_tpu_torch.config import ModelConfig, TrainConfig
from subgc_tpu_torch.data.synthetic import synthetic_train_batch
from subgc_tpu_torch.models.params import (init_params, init_params_numpy,
                                           params_from_numpy)
from subgc_tpu_torch.train import checkpoint as C
from subgc_tpu_torch.train import optim as O
from subgc_tpu_torch.train.step import (batch_to_device, init_train_state,
                                        make_train_step, make_val_step)

from .test_torch_port_train import flat_paths, one_thread  # noqa: F401

WIDTHS = dict(vocab_size=30, seq_length=12, rnn_size=32,
              input_encoding_size=24, att_hid_size=16, gcn_dim=20,
              fc_feat_size=32, att_feat_size=40, embed_dim=12,
              num_obj_classes=15, num_rel_classes=8, drop_prob_lm=0.0)


@pytest.mark.parametrize("kw", [{}, dict(learning_rate=3e-3, warmup_n=7,
                                         learning_rate_decay_rate=0.7,
                                         learning_rate_decay_every=2),
                                dict(learning_rate_decay_start=-1),
                                dict(learning_rate_decay_start=3,
                                     scheduled_sampling_start=2)])
def test_schedules_equal_jax_exactly(kw):
    tcfg, jtcfg = TrainConfig(**kw), JTrainConfig(**kw)
    for it in (0, 1, 2, 6, 7, 8, 150, 299, 300, 301, 5000, 123456):
        for epoch in (0, 1, 2, 3, 4, 6, 9, 20, 35, 60):
            want = np.asarray(JO.learning_rate(jnp.int32(it),
                                               jnp.int32(epoch), jtcfg))
            assert O.learning_rate(it, epoch, tcfg) == float(want), \
                (it, epoch)
            assert O.ss_prob(epoch, tcfg) == JO.ss_prob(epoch, jtcfg)
    assert O.learning_rate(0, 0, tcfg) == 0.0


def _adam_state(opt_state):
    """optax's ScaleByAdamState inside the chain's state."""
    if hasattr(opt_state, "mu"):
        return opt_state
    children = opt_state if isinstance(opt_state, tuple) else \
        [getattr(opt_state, "inner_state", None)]
    for c in children:
        if c is not None and (found := _adam_state(c)) is not None:
            return found
    return None


def _set_lr(opt_state, lr):
    """The scheduled LR in the chain's inject_hyperparams state.  (The JAX
    package's own ``set_step_lr`` expects the chain without weight decay:
    with it, the state nests one level deeper and ``set_step_lr`` raises
    AttributeError, a reference-side limitation no preset meets.)"""
    if hasattr(opt_state, "hyperparams"):
        return opt_state._replace(hyperparams={**opt_state.hyperparams,
                                               "learning_rate": lr})
    if isinstance(opt_state, tuple) and not hasattr(opt_state, "_fields"):
        return tuple(_set_lr(c, lr) for c in opt_state)
    return opt_state


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adam_update_matches_optax_chain(weight_decay):
    """Three steps on identical gradients: the second one clipped (norm
    above 10), one parameter without a gradient (None in the port, zeros
    for optax), a learning rate per step."""
    rng = np.random.RandomState(0)
    params = {"a": {"w": rng.randn(7, 5).astype("f"),
                    "b": rng.randn(5).astype("f")},
              "l": [rng.randn(3, 4).astype("f"), rng.randn(6).astype("f")]}
    kw = dict(weight_decay=weight_decay, learning_rate=1e-2)
    tcfg, jtcfg = TrainConfig(**kw), JTrainConfig(**kw)
    opt = JO.build_optimizer(jtcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = opt.init(jp)
    tp = params_from_numpy(params, "cpu", requires_grad=True)
    tstate = O.init_opt_state(tp, tcfg)
    paths = list(flat_paths(params))
    for step, (scale, lr) in enumerate([(0.1, 1e-2), (30.0, 5e-3),
                                        (0.5, 2e-3)]):
        grads = {p: (rng.randn(*params_shape) * scale).astype("f")
                 for p, params_shape in
                 ((p, v.shape) for p, v in flat_paths(params).items())}
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
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(jg)),
                                   rtol=1e-6)
        assert (norm.item() >= 10.0) == (step == 1)
        ja = _adam_state(jstate)
        # params: optax's bias correction 1 - b2**t runs under jit, where
        # XLA rounds float32 ** int32 a few ulps away from IEEE binary
        # powering (the port's, and eager jax's); the cancellation in
        # 1 - b2**t makes that up to ~1e-5 of the step, so params also get
        # atol 1e-5 x lr (an element near zero); the moments do not depend
        # on it
        for name, got, want, atol in (
                ("params", tp, jp, 1e-5 * lr), ("mu", tstate.mu, ja.mu, 0),
                ("nu", tstate.nu, ja.nu, 0)):
            g, w = flat_paths(got), flat_paths(want)
            for p in paths:
                np.testing.assert_allclose(g[p], w[p], rtol=1e-6, atol=atol,
                                           err_msg=f"{name} {p} step {step}")
        assert tstate.count == int(ja.count) == step + 1


def test_optimizers_other_than_adam_name_their_roadmap_item():
    """ROADMAP item 11 is ported: the four optimizers other than Adam are
    no longer refused and build their state (held against optax in
    ``tests/test_torch_port_optim_extras.py``); an unknown name raises."""
    for name in ("adamw", "sgd", "rmsprop", "adagrad"):
        st = O.init_opt_state({"w": torch.zeros(2)}, TrainConfig(optim=name))
        assert st.kind == name and st.count == 0
        assert sorted(st.moments) == sorted(O.MOMENTS[name])
    with pytest.raises(ValueError, match="unknown optim"):
        O.init_opt_state({}, TrainConfig(optim="lbfgs"))


def test_three_train_steps_match_jax_from_a_jax_checkpoint(tmp_path):
    """The port resumes a JAX checkpoint and takes the same three steps as
    the JAX package's jitted step (hoisted path, LR 0 then the warmup)."""
    jcfg = JModelConfig(**WIDTHS)
    cfg = ModelConfig(**WIDTHS)
    jtcfg, tcfg = JTrainConfig(batch_size=3, warmup_n=2), \
        TrainConfig(batch_size=3, warmup_n=2)
    params, state = init_params_numpy(cfg, seed=1)
    j_save(str(tmp_path), params, state, None, {"iter": 0}, {})
    params, state = (jax.tree_util.tree_map(jnp.asarray, t)
                     for t in (params, state))
    opt = JO.build_optimizer(jtcfg)
    jstep = JST.make_train_step(jcfg, jtcfg, opt, ss_active=False)
    ts = JST.init_train_state(params, state, opt)
    jb = j_batch(jcfg, 3, seed=2)
    z = jnp.zeros((), jnp.int32), jnp.zeros(())
    j_losses = []
    for _ in range(3):
        ts, m = jstep(ts, jb, None, *z)
        j_losses.append(float(m["loss"]))

    p_np, s_np, moments, infos, _ = C.load_checkpoint(str(tmp_path))
    assert moments is None and infos == {"iter": 0}
    pts = init_train_state(params_from_numpy(p_np, "cpu", True),
                           params_from_numpy(s_np, "cpu"), tcfg)
    step = make_train_step(cfg, tcfg, ss_active=False)
    b = batch_to_device(synthetic_train_batch(cfg, 3, seed=2), "cpu")
    losses, lrs = [], []
    for _ in range(3):
        pts, m = step(pts, b, None, 0, 0.0)
        losses.append(m["loss"].item())
        lrs.append(m["lr"].item())
    assert lrs[0] == 0.0 and lrs[2] == pytest.approx(5e-4)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    got, want = flat_paths(pts.params), flat_paths(ts.params)
    assert sorted(got) == sorted(want)
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=0, atol=1e-5,
                                   err_msg=str(p))
    assert pts.step == 3 and pts.opt_state.count == 3
    jv = JST.make_val_step(jcfg)(ts.params, ts.model_state, jb)
    pv = make_val_step(cfg)(pts.params, pts.model_state, b)
    np.testing.assert_allclose(pv.item(), float(jv), rtol=1e-4)


def test_thirty_steps_on_one_batch_lower_the_loss():
    """Dropout on (a seeded generator) and the scheduled-sampling step for
    the second half: training still learns, every metric stays finite."""
    cfg = ModelConfig(**{**WIDTHS, "drop_prob_lm": 0.5})
    tcfg = TrainConfig(batch_size=2, learning_rate=3e-3, warmup_n=1)
    params, state = init_params(cfg, seed=0, device="cpu",
                                requires_grad=True)
    ts = init_train_state(params, state, tcfg)
    hoisted = make_train_step(cfg, tcfg, ss_active=False)
    ss = make_train_step(cfg, tcfg)
    b = batch_to_device(synthetic_train_batch(cfg, 2, seed=5), "cpu")
    g = torch.Generator().manual_seed(0)
    losses = []
    for i in range(30):
        step = hoisted if i < 15 else ss
        ts, m = step(ts, b, g, 0, 0.0 if i < 15 else 0.25)
        assert all(torch.isfinite(v) for v in m.values()), m
        losses.append(m["loss"].item())
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses


def test_losses_and_host_schedules_match_jax():
    """language_model_loss, label_smoothing_loss and reward_loss (with and
    without the per-row sGPN term) against the JAX package's on the same
    inputs (rtol 1e-6); noam_schedule and ReduceLROnPlateau step for step
    (rtol 1e-6, the JAX schedule being float32)."""
    from subgc_tpu.train import loss as JL
    from subgc_tpu_torch.train import loss as L
    rng = np.random.RandomState(9)
    lp = np.log(rng.dirichlet(np.ones(11), (4, 6))).astype("f")
    tgt = rng.randint(0, 11, (4, 8)).astype(np.int64)
    msk = (rng.rand(4, 8) > 0.3).astype("f")
    msk[:, 0] = 1
    t = [torch.from_numpy(a) for a in (lp, tgt, msk)]
    j = [jnp.asarray(a) for a in (lp, tgt.astype(np.int32), msk)]
    np.testing.assert_allclose(L.language_model_loss(*t).item(),
                               float(JL.language_model_loss(*j)), rtol=1e-6)
    np.testing.assert_allclose(
        L.label_smoothing_loss(*t, smoothing=0.2).item(),
        float(JL.label_smoothing_loss(*j, smoothing=0.2)), rtol=1e-6)
    slp = rng.randn(4, 6).astype("f")
    seq = rng.randint(0, 5, (4, 6)).astype(np.int64)
    rew = rng.randn(4, 6).astype("f")
    gl = rng.rand(4).astype("f")
    for g in (None, gl):
        got = L.reward_loss(torch.from_numpy(slp), torch.from_numpy(seq),
                            torch.from_numpy(rew),
                            None if g is None else torch.from_numpy(g))
        want = JL.reward_loss(jnp.asarray(slp), jnp.asarray(seq),
                              jnp.asarray(rew),
                              None if g is None else jnp.asarray(g))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    port, ref = O.noam_schedule(512, 2.0, 400), JO.noam_schedule(512, 2.0,
                                                                  400)
    for s in (0, 1, 7, 399, 400, 401, 5000):
        np.testing.assert_allclose(port(s), float(ref(jnp.int32(s))),
                                   rtol=1e-6)
    a, b = O.ReduceLROnPlateau(patience=2), JO.ReduceLROnPlateau(patience=2)
    for v in (3.0, 2.0, 2.1, 2.2, 2.05, 2.3, 1.0, 1.5, 1.6, 1.7):
        assert a.step(v) == b.step(v)
