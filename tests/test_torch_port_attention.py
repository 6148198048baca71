"""The port's beam-shared attention (subgc_tpu_torch/ops/attention.py) held
against the JAX package: ``decoder.attention`` in both beam layouts and the
Pallas kernel ``fused_attention_shared`` in interpret mode.

Tolerance rtol 1e-5 / atol 1e-5 (float32, summation order differs).  The
CUDA kernel itself is checked against this plain version on the card by
``tests/test_torch_port_kernels.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subgc_tpu.models import decoder as JD
from subgc_tpu.ops.pallas_attention import fused_attention_shared
from subgc_tpu_torch.ops import attention as A

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(cfg, layout, seed=0, S=6, B=2, G=3):
    """numpy inputs of one beam layout; streams [G or S, n, *]."""
    rng = np.random.RandomState(seed)
    n, R, H = cfg.obj_num, cfg.rnn_size, cfg.att_hid_size
    rows = G if layout == "image" else S
    x = {
        "h": rng.uniform(-1, 1, (S, B, R)).astype("f"),
        "p_att": rng.randn(rows, n, H).astype("f"),
        "att": rng.rand(rows, n, R).astype("f"),
        "mask": (rng.rand(S, n) > 0.6).astype("f"),
        "idx": (np.repeat(np.arange(G), -(-S // G))[:S] if layout == "image"
                else np.arange(S)).astype(np.int32),
    }
    x["mask"][:, 0] = 1.0          # every row attends over >= 1 node
    return x


def _weights(tiny_params):
    dec = tiny_params[0]["decoder"]
    return [np.array(a) for a in (dec["h2att"]["w"], dec["h2att"]["b"],
                                    dec["alpha_net"]["w"],
                                    dec["alpha_net"]["b"])]


def _port_ref(x, w):
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    out, wt = A.shared_attention_ref(t["h"], t["p_att"], t["att"], t["mask"],
                                     t["idx"], *map(torch.from_numpy, w))
    return out.numpy(), wt.numpy()


def _jax_attention(params, cfg, x, layout):
    """decoder.attention under the beam search's per-sub-graph vmap."""
    p = jax.tree_util.tree_map(jnp.asarray, params)
    if layout == "image":
        def one(h, mask, ii):
            f = JD.PreparedFeatures(fc=None, att=None, p_att=None, mask=mask,
                                    fc_ih=None, att_img=jnp.asarray(x["att"]),
                                    p_att_img=jnp.asarray(x["p_att"]),
                                    img_ix=ii)
            return JD.attention(p, h, f, cfg)
        args = (x["h"], x["mask"], x["idx"])
    else:
        def one(h, p_att, att, mask):
            f = JD.PreparedFeatures(fc=None, att=att, p_att=p_att, mask=mask,
                                    fc_ih=None)
            return JD.attention(p, h, f, cfg)
        args = (x["h"], x["p_att"], x["att"], x["mask"])
    out, w = jax.vmap(one)(*map(jnp.asarray, args))
    return np.asarray(out), np.asarray(w)


@pytest.mark.parametrize("layout", ["image", "subgraph"])
def test_ref_matches_jax_attention(tiny_cfg, tiny_params, layout):
    x = _inputs(tiny_cfg, layout)
    out, w = _port_ref(x, _weights(tiny_params))
    j_out, j_w = _jax_attention(tiny_params[0], tiny_cfg, x, layout)
    np.testing.assert_allclose(w, j_w, **TOL)
    np.testing.assert_allclose(out, j_out, **TOL)


def test_ref_matches_pallas_interpret(tiny_cfg, tiny_params):
    x = _inputs(tiny_cfg, "subgraph", seed=1)
    wts = _weights(tiny_params)
    out, w = _port_ref(x, wts)
    p_out, p_w = fused_attention_shared(
        *(jnp.asarray(x[k]) for k in ("h", "p_att", "att", "mask")),
        *map(jnp.asarray, wts), interpret=True)
    np.testing.assert_allclose(w, np.asarray(p_w), **TOL)
    np.testing.assert_allclose(out, np.asarray(p_out), **TOL)


def test_wrapper_on_cpu_is_plain_and_uncounted(tiny_cfg, tiny_params):
    x = _inputs(tiny_cfg, "image", seed=2)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    wts = [torch.from_numpy(a) for a in _weights(tiny_params)]
    before = A.LAUNCHES
    out, w = A.shared_attention(t["h"], t["p_att"], t["att"], t["mask"],
                                t["idx"], *wts)
    assert A.LAUNCHES == before
    r_out, r_w = _port_ref(x, _weights(tiny_params))
    np.testing.assert_array_equal(out.numpy(), r_out)
    np.testing.assert_array_equal(w.numpy(), r_w)


def test_ref_all_zero_mask_gives_nan(tiny_cfg, tiny_params):
    """A row whose mask is all zero renormalises 0/0, as the JAX path does."""
    x = _inputs(tiny_cfg, "image", seed=3)
    x["mask"][1] = 0.0
    out, w = _port_ref(x, _weights(tiny_params))
    assert np.isnan(w[1]).all() and np.isfinite(w[0]).all()


def test_per_row_attention_matches_jax(tiny_cfg, tiny_params):
    """The per-row layout (h [S, R], streams [S, N, *]; grounding's) stays
    plain torch in the port's decoder.attention."""
    from subgc_tpu_torch.config import ModelConfig
    from subgc_tpu_torch.models import decoder as D
    from subgc_tpu_torch.models.params import params_from_numpy

    x = _inputs(tiny_cfg, "subgraph", seed=5)
    h = x["h"][:, 0]
    f = dict(fc=None, att=x["att"], p_att=x["p_att"], mask=x["mask"],
             fc_ih=None)
    j_out, j_w = JD.attention(tiny_params[0], jnp.asarray(h),
                              JD.PreparedFeatures(**{
                                  k: None if v is None else jnp.asarray(v)
                                  for k, v in f.items()}), tiny_cfg)
    cfg = ModelConfig(**{k: getattr(tiny_cfg, k)
                         for k in ModelConfig.__dataclass_fields__})
    tp = params_from_numpy(jax.tree_util.tree_map(np.array, tiny_params[0]),
                           "cpu")
    out, w = D.attention(tp, torch.from_numpy(h), D.PreparedFeatures(**{
        k: None if v is None else torch.from_numpy(v)
        for k, v in f.items()}), cfg)
    np.testing.assert_allclose(w.numpy(), np.asarray(j_w), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)
