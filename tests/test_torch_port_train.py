"""The port's teacher-forced training forward and its gradients held
against the JAX package's ``train_forward`` and ``jax.grad``, for the five
train presets' model configs (Sub-GC, the Sup. model's ``use_gt_subg``,
Full-GC with its GCN BatchNorm), ``use_bn`` 1/2 and ``share_att_train``,
at tiny widths on the CPU.

Both sides train with dropout off (``drop_prob_lm=0``, no rng or
generator) and BatchNorm on batch statistics.  Tolerances: logprobs atol
1e-5, sGPN loss and new BatchNorm state atol 1e-6, every parameter's
gradient rtol 1e-4 / atol 1e-6 (float32 summation order through 17 LSTM
steps).  Gradient-dead parameters (the GCN's alternating units and the
predicate embeddings, tests/test_grad_parity.py) are None or zero in the
port and zero in jax.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subgc_tpu.config import ModelConfig as JModelConfig
from subgc_tpu.data.synthetic import synthetic_train_batch as j_batch
from subgc_tpu.models import subgc as JS
from subgc_tpu.train.loss import language_model_loss as j_lang_loss
from subgc_tpu_torch.config import ModelConfig
from subgc_tpu_torch.data.synthetic import synthetic_train_batch
from subgc_tpu_torch.models import subgc as S
from subgc_tpu_torch.models.params import init_params_numpy, params_from_numpy
from subgc_tpu_torch.train.loss import language_model_loss
from subgc_tpu_torch.train.optim import tree_leaves
from subgc_tpu_torch.train.step import batch_to_device

WIDTHS = dict(vocab_size=50, seq_length=16, rnn_size=64,
              input_encoding_size=48, att_hid_size=32, gcn_dim=40,
              fc_feat_size=64, att_feat_size=80, embed_dim=20,
              num_obj_classes=30, num_rel_classes=10, drop_prob_lm=0.0)
FULL_GC = dict(noun_fuse=False, pred_emb_type=2, gcn_layers=4,
               gcn_residual=1, gcn_bn=True, use_gpn=False)
CASES = {"sub_gc": {}, "sup": dict(use_gt_subg=True), "full_gc": FULL_GC,
         "use_bn1": dict(use_bn=1), "use_bn2": dict(use_bn=2),
         "share_att_train": dict(share_att_train=True)}
# the BatchNorm cases run from tests/test_torch_port_train_bn.py, so that
# each file stays short
BN_CASES = ("full_gc", "use_bn1", "use_bn2")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread at these tiny widths: the parallel test workers
    share the cores, and torch's default of one thread per core
    oversubscribes them (a 1 s test took 100 s so).  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(jcfg):
    return ModelConfig(**{f: getattr(jcfg, f)
                          for f in ModelConfig.__dataclass_fields__})


def flat_paths(tree, prefix=()):
    """{path: numpy array} over a nested dict/list tree of any arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_paths(v, prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat_paths(v, prefix + (i,)))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach()
    return {prefix: np.asarray(tree)}


def _jax_loss_and_grads(jcfg, params, state, batch):
    @jax.jit
    def run(p, s, b):
        def loss_fn(p):
            lp, gl, _, ns = JS.train_forward(
                p, s, b.graph, b.labels, b.sub_obj_ind, b.sub_att_mask,
                b.img_ix, jcfg, train=True)
            lang = j_lang_loss(lp, b.labels[:, 1:], b.masks[:, 1:])
            gl = jnp.zeros(()) if gl is None else gl
            return lang + gl, (lp, gl, ns)
        return jax.value_and_grad(loss_fn, has_aux=True)(p)
    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)   # noqa: E731
    return run(to_j(params), to_j(state), batch)


@pytest.mark.parametrize("case", sorted(set(CASES) - set(BN_CASES)))
def test_train_forward_and_gradients_match_jax(case):
    check_case(case)


def check_case(case):
    """train_forward (logprobs, gpn_loss, new state) and every gradient of
    the full loss for one entry of CASES, port against JAX."""
    jcfg = JModelConfig(**WIDTHS, **CASES[case])
    cfg = _port_cfg(jcfg)
    params, state = init_params_numpy(cfg, seed=3, n_obj_names=30,
                                      n_pred_names=10)
    if cfg.gcn_bn:
        rng = np.random.RandomState(4)
        for layer in state["gcn_bn"]:
            for u in layer:
                u["mean"] = rng.normal(0, 0.05, u["mean"].shape).astype("f")
                u["var"] = rng.uniform(0.8, 1.2, u["var"].shape).astype("f")
    (j_loss, (j_lp, j_gl, j_state)), j_grads = _jax_loss_and_grads(
        jcfg, params, state, j_batch(jcfg, 3, seed=5))

    tp = params_from_numpy(params, "cpu", requires_grad=True)
    b = batch_to_device(synthetic_train_batch(cfg, 3, seed=5), "cpu")
    lp, gl, scores, new_state = S.train_forward(
        tp, params_from_numpy(state, "cpu"), b.graph, b.labels,
        b.sub_obj_ind, b.sub_att_mask, b.img_ix, cfg, train=True)
    lang = language_model_loss(lp, b.labels[:, 1:], b.masks[:, 1:])
    total = lang + gl if gl is not None else lang
    grads = torch.autograd.grad(total, tree_leaves(tp), allow_unused=True)

    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(j_lp),
                               rtol=0, atol=1e-5)
    if cfg.use_gpn and not cfg.use_gt_subg:
        np.testing.assert_allclose(gl.item(), float(j_gl), rtol=0, atol=1e-6)
        assert scores.shape == (15, 2, 2)
    else:
        assert gl is None
    np.testing.assert_allclose(total.item(), float(j_loss), rtol=1e-6)
    got_state, want_state = flat_paths(new_state), flat_paths(j_state)
    assert sorted(got_state) == sorted(want_state)
    for k in want_state:
        np.testing.assert_allclose(got_state[k], want_state[k], rtol=0,
                                   atol=1e-6, err_msg=str(k))
    if cfg.gcn_bn:                  # batch statistics moved the state
        assert not np.allclose(got_state[("gcn_bn", 0, 0, "mean")],
                               state["gcn_bn"][0][0]["mean"])

    want = flat_paths(j_grads)
    paths = list(flat_paths(params))
    assert sorted(paths) == sorted(want)
    n_dead = 0
    for path, g in zip(paths, grads):
        if g is None:
            n_dead += 1
            np.testing.assert_allclose(want[path], 0.0, atol=1e-8,
                                       err_msg=str(path))
            continue
        np.testing.assert_allclose(g.numpy(), want[path], rtol=1e-4,
                                   atol=1e-6, err_msg=str(path))
    if cfg.use_gpn:             # two GCN layers: dead units exist
        assert n_dead > 0
