"""The port's SCST (``subgc_tpu_torch/train/scst.py``) held against the JAX
package's ``subgc_tpu/train/scst.py`` on the same weights and batch at the
test widths, dropout off:

* ``compute_rewards`` equal to JAX's (the same CIDEr-D numbers);
* the greedy rollout's tokens equal to JAX ``make_sample_fn``'s;
* for JAX's ``sample_seq`` and rewards, the port's SCST loss within rtol
  1e-5 and every gradient within rtol 1e-4 (atol 1e-6) of
  ``jax.value_and_grad`` of JAX's own ``loss_fn`` (taken from the
  closure of its ``make_scst_update_fn``);
* one full update with Adam at the presets' learning rate: params within
  rtol 1e-4 (atol 1e-6);
* the port's sampled tokens hold nothing after a row's first EOS, and the
  sample's logprobs equal their recomputation under autograd (atol 1e-5);
* the bf16 chain under the bf16 rules of ``tests/test_torch_port_bf16*``:
  greedy token agreement >= 0.95,
  loss within rtol 1e-2, every gradient leaf within 5e-2 relative L2 (the
  attention's score leaves 0.25, ``alpha_net.b`` within 1e-6 of the whole
  norm).

The weights are the port's ``init_params_numpy`` with the LSTM and
embedding weights scaled up, so that random weights decode varied tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subgc_tpu.config import ModelConfig as JModelConfig
from subgc_tpu.config import TrainConfig as JTrainConfig
from subgc_tpu.data.synthetic import synthetic_train_batch as j_batch
from subgc_tpu.train import optim as JO
from subgc_tpu.train import scst as JS
from subgc_tpu.train import step as JST
from subgc_tpu_torch.config import ModelConfig, TrainConfig
from subgc_tpu_torch.data.synthetic import synthetic_train_batch
from subgc_tpu_torch.models.params import init_params_numpy, params_from_numpy
from subgc_tpu_torch.train import scst as S
from subgc_tpu_torch.train.optim import tree_leaves
from subgc_tpu_torch.train.step import batch_to_device, init_train_state

from .test_torch_port_bf16_train import SCORE_LEAVES
from .test_torch_port_train import WIDTHS, flat_paths, one_thread  # noqa

N_IMAGES = 4
VOCAB = {str(i): f"w{i}" for i in range(1, WIDTHS["vocab_size"] + 1)}


def lively(params):
    """Random weights decode one token over and over; scaled LSTM and
    embedding weights make the tokens depend on the inputs."""
    dec = params["decoder"]
    for k in ("att_lstm", "lang_lstm"):
        dec[k] = {n: w * 3 if n.startswith("w_") else w
                  for n, w in dec[k].items()}
    dec["embed"] = dec["embed"] * 4
    return params


def setup(**kw):
    jcfg = JModelConfig(**WIDTHS, **kw)
    cfg = ModelConfig(**{f: getattr(jcfg, f)
                         for f in ModelConfig.__dataclass_fields__})
    params, state = init_params_numpy(cfg, seed=3, n_obj_names=30,
                                      n_pred_names=10)
    params = lively(params)
    jb = jax.tree_util.tree_map(jnp.asarray, j_batch(jcfg, N_IMAGES, seed=5))
    b = batch_to_device(synthetic_train_batch(cfg, N_IMAGES, seed=5), "cpu")
    return jcfg, cfg, params, state, jb, b


def gts_tokens(batch):
    """Each sentence's references: its image's caption rows."""
    labels = np.asarray(batch.labels)[:, 1:-1]
    img = np.asarray(batch.img_ix)
    return [labels[img == img[s]] for s in range(len(img))]


def to_j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def jax_loss_fn(jcfg, jtcfg):
    """JAX's own ``loss_fn``, from the closure of its update function."""
    opt = JO.build_optimizer(jtcfg)
    inner = JS.make_scst_update_fn(jcfg, jtcfg, opt).__wrapped__
    cells = dict(zip(inner.__code__.co_freevars,
                     (c.cell_contents for c in inner.__closure__)))
    return cells["loss_fn"]


def test_compute_rewards_equal_jax():
    rng = np.random.RandomState(0)
    S_, T = 12, 9
    greedy = rng.randint(0, 12, (S_, T))
    sample = rng.randint(0, 12, (S_, T))
    greedy[3] = 0                          # an empty caption: "a"
    sample[5, 2:] = 0
    gts = [rng.randint(1, 12, (5, T)) for _ in range(S_)]
    vocab = {str(i): f"w{i % 7}" for i in range(1, 12)}
    got = S.compute_rewards(greedy, sample, gts, vocab)
    want = JS.compute_rewards(greedy, sample, gts, vocab)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() > 0


@pytest.mark.parametrize("kw", [{}, dict(use_gt_subg=True)])
def test_rollouts_loss_and_gradients_match_jax(kw):
    jcfg, cfg, params, state, jb, b = setup(**kw)
    jtcfg = JTrainConfig(batch_size=N_IMAGES)
    j_greedy, j_sample, _ = jax.device_get(JS.make_sample_fn(jcfg)(
        to_j(params), to_j(state), jb, jax.random.PRNGKey(3)))
    tp = params_from_numpy(params, "cpu", requires_grad=True)
    ts_state = params_from_numpy(state, "cpu")
    gen = torch.Generator().manual_seed(0)
    greedy, sample, lps = S.make_sample_fn(cfg)(tp, ts_state, b, gen)
    np.testing.assert_array_equal(greedy.numpy(), j_greedy)
    assert len(np.unique(greedy.numpy())) > 3, "degenerate decode"
    assert not greedy.requires_grad and not lps.requires_grad

    # the update at JAX's sample and rewards
    refs = gts_tokens(b)
    rewards = JS.compute_rewards(j_greedy, j_sample, refs, VOCAB)
    assert np.abs(rewards).max() > 0
    j_loss, j_grads = jax.jit(jax.value_and_grad(jax_loss_fn(jcfg, jtcfg)))(
        to_j(params), to_j(state), jb, jnp.asarray(j_sample),
        jnp.asarray(rewards))
    seq = torch.from_numpy(np.asarray(j_sample, np.int64))
    loss = S.scst_loss(tp, ts_state, b, seq, torch.from_numpy(rewards), cfg)
    grads = torch.autograd.grad(loss, tree_leaves(tp), allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    want = flat_paths(j_grads)
    paths = list(flat_paths(params))
    assert sorted(paths) == sorted(want)
    for path, g in zip(paths, grads):
        if g is None:
            np.testing.assert_allclose(want[path], 0.0, atol=1e-8,
                                       err_msg=str(path))
            continue
        np.testing.assert_allclose(g.numpy(), want[path], rtol=1e-4,
                                   atol=1e-6, err_msg=str(path))
    assert any(g is not None and g.abs().sum() > 0 and p[0] == "decoder"
               for p, g in zip(paths, grads))


def test_one_update_with_adam_matches_jax():
    jcfg, cfg, params, state, jb, b = setup()
    # the presets' learning rate: Adam's first step moves an element by
    # ~lr, but one whose gradient is near eps by a share of lr that float
    # sums decide (measured 3e-3 x lr apart at lr 5e-3, one element)
    kw = dict(batch_size=N_IMAGES, warmup_n=2)
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    opt = JO.build_optimizer(jtcfg)
    jts = JST.init_train_state(to_j(params), to_j(state), opt)
    jts = jts._replace(step=jnp.asarray(1, jnp.int32))
    j_greedy, j_sample, _ = jax.device_get(JS.make_sample_fn(jcfg)(
        jts.params, jts.model_state, jb, jax.random.PRNGKey(1)))
    rewards = JS.compute_rewards(j_greedy, j_sample, gts_tokens(b), VOCAB)
    jts, j_loss = JS.make_scst_update_fn(jcfg, jtcfg, opt)(
        jts, jb, jnp.asarray(j_sample), jnp.asarray(rewards),
        jnp.zeros((), jnp.int32))

    ts = init_train_state(params_from_numpy(params, "cpu", True),
                          params_from_numpy(state, "cpu"), tcfg, step=1)
    ts, loss = S.make_scst_update_fn(cfg, tcfg)(
        ts, b, torch.from_numpy(np.asarray(j_sample, np.int64)),
        torch.from_numpy(rewards), 0)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    assert ts.step == 2 and ts.opt_state.count == 1
    got, want = flat_paths(ts.params), flat_paths(jts.params)
    moved = 0
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=1e-4, atol=1e-6,
                                   err_msg=str(p))
        moved += not np.array_equal(got[p], flat_paths(params)[p])
    assert moved > 10


def test_samples_end_at_eos_and_logprobs_match_the_update():
    _, cfg, params, state, _, b = setup()
    tp = params_from_numpy(params, "cpu", requires_grad=True)
    st = params_from_numpy(state, "cpu")
    _, sample, lps = S.make_sample_fn(cfg)(
        tp, st, b, torch.Generator().manual_seed(7))
    tok = sample.numpy()
    ended = np.cumsum(tok == 0, axis=1) > 0
    assert ended.any(axis=1).sum() >= 2, "no row drew an EOS"
    assert (tok[ended] == 0).all()
    assert tok.min() >= 0 and tok.max() <= cfg.vocab_size
    # the recomputation under autograd attends through attention_teacher;
    # it agrees with the no-grad dispatch up to and including each EOS
    again = S.sample_logprobs(tp, st, b, sample, cfg)
    assert again.requires_grad
    live = np.concatenate([np.ones_like(ended[:, :1]), ~ended[:, :-1]], 1)
    np.testing.assert_allclose(again.detach().numpy()[live],
                               lps.numpy()[live], rtol=0, atol=1e-5)
    assert np.isfinite(lps.numpy()).all() and (lps.numpy() <= 0).all()


def test_bf16_chain_under_the_bf16_rules():
    kw = dict(compute_dtype="bfloat16", bf16_lstm_gates=True)
    jcfg, cfg, params, state, jb, b = setup(**kw)
    jtcfg = JTrainConfig(batch_size=N_IMAGES)
    j_greedy, j_sample, _ = jax.device_get(JS.make_sample_fn(jcfg)(
        to_j(params), to_j(state), jb, jax.random.PRNGKey(3)))
    tp = params_from_numpy(params, "cpu", requires_grad=True)
    ts_state = params_from_numpy(state, "cpu")
    greedy, _, lps = S.make_sample_fn(cfg)(tp, ts_state, b,
                                           torch.Generator().manual_seed(0))
    assert lps.dtype == torch.float32
    assert (greedy.numpy() == j_greedy).mean() >= 0.95

    rewards = JS.compute_rewards(j_greedy, j_sample, gts_tokens(b), VOCAB)
    args = [to_j(params), to_j(state), jb, jnp.asarray(j_sample),
            jnp.asarray(rewards)]
    fn = jax.jit(jax.value_and_grad(jax_loss_fn(jcfg, jtcfg))).lower(
        *args).compile(compiler_options={"xla_allow_excess_precision": False})
    j_loss, j_grads = fn(*args)
    loss = S.scst_loss(tp, ts_state, b,
                       torch.from_numpy(np.asarray(j_sample, np.int64)),
                       torch.from_numpy(rewards), cfg)
    grads = torch.autograd.grad(loss, tree_leaves(tp), allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-2)
    want = flat_paths(j_grads)
    total = np.sqrt(sum(float(np.sum(np.square(w, dtype=np.float64)))
                        for w in want.values()))
    for path, g in zip(flat_paths(params), grads):
        w = want[path]
        if g is None:
            np.testing.assert_allclose(w, 0.0, atol=1e-8, err_msg=str(path))
            continue
        assert g.dtype == torch.float32, path
        g = g.numpy()
        err, norm = np.linalg.norm(g - w), np.linalg.norm(w)
        if path == ("decoder", "alpha_net", "b"):
            assert np.abs(g).max() <= 1e-6 * total, path
        elif path in SCORE_LEAVES:
            assert err <= 0.25 * norm, (path, err / norm)
        elif norm > 0:
            assert err <= 5e-2 * norm, (path, err / norm)
        else:
            assert not g.any(), path
