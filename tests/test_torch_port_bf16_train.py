"""Training in the port's bfloat16 chain held against the JAX package:
``train_forward``'s loss and every gradient under ``compute_dtype=
"bfloat16"`` (plain, with ``bf16_lstm_gates``, with bf16 gates and
``bf16_residuals``, and under ``share_att_train``) against
``jax.value_and_grad`` with dropout off, on the same weights and batch at
the test widths.

The JAX side is jitted with XLA's ``xla_allow_excess_precision`` off, so
that it rounds where its source does, as the port does: with it on, XLA
drops the bf16 rounding of a product that is cast back to float32 at once
(``_dense``), which alone moves the read-out and fc_embed gradients by ~5%
(measured; with it off, and in eager JAX, they agree with the port within
0.4%).

Bounds, each with its reason:

* loss: rtol 1e-2 (measured ~1e-6);
* every gradient leaf: relative L2 error <= 5e-2;
* the word embedding (both packages scatter-add its gradient into a bf16
  table, in different orders): relative L2 <= 2e-2 (measured 6e-3);
* the attention's score leaves ``ctx2att.b``, ``h2att.w``, ``h2att.b``,
  whose gradients are sums in which the softmax's shift invariance cancels
  nearly everything (5e-5 of the gradient's norm): relative L2 <= 0.25
  and cosine >= 0.97; the JAX package's own eager and jitted evaluations
  of the same bf16 gradient differ by 6-14% there (measured);
* ``alpha_net.b``, whose exact gradient is 0: within 1e-6 of the whole
  gradient's norm.

The train steps and the CLIs in bf16 are
``tests/test_torch_port_bf16_train_cli.py``.
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

from .test_torch_port_train import WIDTHS, flat_paths, one_thread  # noqa

CASES = {"bf16": {}, "gates": dict(bf16_lstm_gates=True),
         "gates_resid": dict(bf16_lstm_gates=True, bf16_residuals=True),
         "share_att_train": dict(bf16_lstm_gates=True, share_att_train=True)}
SCORE_LEAVES = {("decoder", "ctx2att", "b"), ("decoder", "h2att", "w"),
                ("decoder", "h2att", "b")}


def _jax_loss_and_grads(jcfg, params, state, batch):
    """value_and_grad of the JAX train loss, jitted to round where its
    source rounds (no excess precision)."""
    def loss_fn(p, s, b):
        lp, gl, _, _ = JS.train_forward(p, s, b.graph, b.labels,
                                        b.sub_obj_ind, b.sub_att_mask,
                                        b.img_ix, jcfg, train=True)
        return j_lang_loss(lp, b.labels[:, 1:], b.masks[:, 1:]) + gl

    args = [jax.tree_util.tree_map(jnp.asarray, t)
            for t in (params, state, batch)]
    fn = jax.jit(jax.value_and_grad(loss_fn)).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return fn(*args)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_train_loss_and_gradients_match_jax(case):
    jcfg = JModelConfig(**WIDTHS, compute_dtype="bfloat16", **CASES[case])
    cfg = ModelConfig(**{f: getattr(jcfg, f)
                         for f in ModelConfig.__dataclass_fields__})
    params, state = init_params_numpy(cfg, seed=3, n_obj_names=30,
                                      n_pred_names=10)
    j_loss, j_grads = _jax_loss_and_grads(jcfg, params, state,
                                          j_batch(jcfg, 3, seed=5))
    tp = params_from_numpy(params, "cpu", requires_grad=True)
    b = batch_to_device(synthetic_train_batch(cfg, 3, seed=5), "cpu")
    lp, gl, _, _ = S.train_forward(tp, params_from_numpy(state, "cpu"),
                                   b.graph, b.labels, b.sub_obj_ind,
                                   b.sub_att_mask, b.img_ix, cfg, train=True)
    loss = language_model_loss(lp, b.labels[:, 1:], b.masks[:, 1:]) + gl
    grads = torch.autograd.grad(loss, tree_leaves(tp), allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-2)

    want = flat_paths(j_grads)
    total = np.sqrt(sum(float(np.sum(np.square(w, dtype=np.float64)))
                        for w in want.values()))
    for path, g in zip(flat_paths(params), grads):
        w = want[path]
        if g is None:                  # gradient-dead (tests/test_grad_parity)
            np.testing.assert_allclose(w, 0.0, atol=1e-8, err_msg=str(path))
            continue
        assert g.dtype == torch.float32, path     # float32 masters
        g = g.numpy()
        err, norm = np.linalg.norm(g - w), np.linalg.norm(w)
        if path == ("decoder", "alpha_net", "b"):
            assert np.abs(g).max() <= 1e-6 * total, path
        elif path in SCORE_LEAVES:
            cos = float(np.dot(g.ravel(), w.ravel())
                        / (np.linalg.norm(g) * norm))
            assert err <= 0.25 * norm and cos >= 0.97, (path, err / norm,
                                                        cos)
        elif norm > 0:
            bound = 2e-2 if path == ("decoder", "embed") else 5e-2
            assert err <= bound * norm, (path, err / norm)
        else:
            assert not g.any(), path
