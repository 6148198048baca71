"""The port's attention in the bfloat16 chain held against the JAX package:
the bf16 plain versions of both kernels (``ops/attention.py``) against the
Pallas kernels run in interpret mode on bf16 inputs and against
``decoder.attention`` under ``compute_dtype="bfloat16"``, and the training
route ``decoder.attention_teacher`` against ``decoder.attention`` called
eagerly in bf16.  Inputs from numpy seeds, weights from the JAX package's
``init_params`` at the test widths.

Tolerances, each with its reason:

* shared plain vs ``fused_attention_shared``: weights atol 2e-3 and
  ``att_res`` (the Pallas kernel stores it in bf16, so the port's float32
  result is rounded to bf16 first) rtol 1e-2, one bf16 ulp being 2^-8
  relative: both round at the same places, but ``ah``'s float32 sum before
  its one rounding, and the tanh of two libraries, may land a rounding on
  the other side;
* shared plain vs ``decoder.attention`` (bf16): weights atol 1e-2, att_res
  rtol / atol 2e-2: XLA also rounds the logits' product and the
  projection's product, the kernel does not;
* row plain vs ``fused_attention``: rtol / atol 1e-5, float32 math on the
  upcast streams in both;
* ``attention_teacher`` vs eager ``decoder.attention``: atol 1e-4, the
  same bf16 roundings op for op (measured: equal but for float32 summation
  order; a one-ulp tanh difference between the two CPU libraries would
  move a logit by ~1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subgc_tpu.models import decoder as JD
from subgc_tpu.ops.pallas_attention import fused_attention, \
    fused_attention_shared
from subgc_tpu_torch.config import ModelConfig
from subgc_tpu_torch.models import decoder as D
from subgc_tpu_torch.models.params import params_from_numpy
from subgc_tpu_torch.ops import attention as A

BF = jnp.bfloat16


def _bf(x):
    """numpy float32 -> a bf16 tensor and the same values as a JAX bf16
    array."""
    x = np.asarray(x, np.float32)
    return torch.from_numpy(x).to(torch.bfloat16), jnp.asarray(x).astype(BF)


def _f32(t):
    return np.asarray(jnp.asarray(t).astype(jnp.float32)) \
        if not isinstance(t, torch.Tensor) else t.float().numpy()


def _weights(tiny_params):
    dec = tiny_params[0]["decoder"]
    return [np.array(a, np.float32) for a in (
        dec["h2att"]["w"], dec["h2att"]["b"], dec["alpha_net"]["w"],
        dec["alpha_net"]["b"])]


def _inputs(cfg, layout, seed, S=6, B=2, G=3):
    rng = np.random.RandomState(seed)
    n, R, H = cfg.obj_num, cfg.rnn_size, cfg.att_hid_size
    rows = G if layout == "image" else S
    x = {"h": rng.uniform(-1, 1, (S, B, R)),
         "p_att": rng.randn(rows, n, H) * 0.5,
         "att": rng.rand(rows, n, R),
         "mask": (rng.rand(S, n) > 0.6).astype("f"),
         "idx": (np.repeat(np.arange(G), -(-S // G))[:S] if layout == "image"
                 else np.arange(S)).astype(np.int32)}
    x["mask"][:, 0] = 1.0
    return x


def _port_shared(x, w):
    """The bf16 plain version on the wrapper's arguments."""
    wh, bh, v, bv = w
    return A.shared_attention_ref(
        _bf(x["h"])[0], _bf(x["p_att"])[0], _bf(x["att"])[0],
        torch.from_numpy(x["mask"]), torch.from_numpy(x["idx"]),
        _bf(wh)[0], torch.from_numpy(bh), _bf(v)[0], torch.from_numpy(bv))


def _bf16_cfg(tiny_cfg):
    return tiny_cfg.replace(compute_dtype="bfloat16")


@pytest.mark.parametrize("layout,beams", [("image", 2), ("subgraph", 2),
                                          ("image", 1)])
def test_bf16_shared_ref_matches_pallas_interpret(tiny_cfg, tiny_params,
                                                  layout, beams):
    """Both beam layouts and one beam (the greedy fan-out); the Pallas
    kernel reads per-row streams, so the image streams are gathered for
    it."""
    x = _inputs(tiny_cfg, layout, seed=beams, B=beams)
    w = _weights(tiny_params)
    out, wt = _port_shared(x, w)
    g = x["idx"]
    p_out, p_w = fused_attention_shared(
        _bf(x["h"])[1], _bf(x["p_att"][g])[1], _bf(x["att"][g])[1],
        jnp.asarray(x["mask"]), _bf(w[0])[1], jnp.asarray(w[1]),
        _bf(w[2])[1], jnp.asarray(w[3]), interpret=True)
    assert p_out.dtype == BF and p_w.dtype == jnp.float32
    assert out.dtype == wt.dtype == torch.float32
    np.testing.assert_allclose(wt.numpy(), np.asarray(p_w), rtol=0,
                               atol=2e-3)
    np.testing.assert_allclose(_f32(out.to(torch.bfloat16)), _f32(p_out),
                               rtol=1e-2, atol=1e-6)


@pytest.mark.parametrize("layout", ["image", "subgraph"])
def test_bf16_shared_ref_matches_xla_attention(tiny_cfg, tiny_params,
                                               layout):
    """Against ``decoder.attention`` in bf16 under the beam search's
    per-sub-graph vmap (the JAX package's default beam attention)."""
    cfg = _bf16_cfg(tiny_cfg)
    x = _inputs(tiny_cfg, layout, seed=4)
    out, wt = _port_shared(x, _weights(tiny_params))
    p = JD.cast_decoder_weights(
        jax.tree_util.tree_map(jnp.asarray, tiny_params[0]), cfg)
    p_bf, a_bf = _bf(x["p_att"])[1], _bf(x["att"])[1]
    if layout == "image":
        def one(h, mask, ii):
            f = JD.PreparedFeatures(fc=None, att=None, p_att=None, mask=mask,
                                    fc_ih=None, att_img=a_bf, p_att_img=p_bf,
                                    img_ix=ii)
            return JD.attention(p, h, f, cfg)
        args = (_bf(x["h"])[1], jnp.asarray(x["mask"]), jnp.asarray(x["idx"]))
    else:
        def one(h, pa, a, mask):
            f = JD.PreparedFeatures(fc=None, att=a, p_att=pa, mask=mask,
                                    fc_ih=None)
            return JD.attention(p, h, f, cfg)
        args = (_bf(x["h"])[1], p_bf, a_bf, jnp.asarray(x["mask"]))
    j_out, j_w = jax.vmap(one)(*args)
    np.testing.assert_allclose(wt.numpy(), np.asarray(j_w), rtol=0,
                               atol=1e-2)
    np.testing.assert_allclose(out.numpy(), _f32(j_out), rtol=2e-2,
                               atol=2e-2)


def test_bf16_row_ref_matches_pallas_interpret(tiny_cfg, tiny_params):
    """``_attention_kernel`` on bf16 streams promotes them: float32 math."""
    rng = np.random.RandomState(5)
    n, R, H = tiny_cfg.obj_num, tiny_cfg.rnn_size, tiny_cfg.att_hid_size
    h, p, a = (rng.uniform(-1, 1, (7, R)), rng.randn(7, n, H),
               rng.rand(7, n, R))
    mask = (rng.rand(7, n) > 0.5).astype("f")
    mask[:, 0] = 1.0
    wh, bh, v, bv = _weights(tiny_params)
    out, wt = A.row_attention_ref(
        _bf(h)[0], _bf(p)[0], _bf(a)[0], torch.from_numpy(mask), _bf(wh)[0],
        torch.from_numpy(bh), _bf(v)[0], torch.from_numpy(bv))
    p_out, p_w = fused_attention(
        _bf(h)[1], _bf(p)[1], _bf(a)[1], jnp.asarray(mask), _bf(wh)[1],
        jnp.asarray(bh), _bf(v)[1], jnp.asarray(bv), interpret=True)
    assert p_out.dtype == p_w.dtype == jnp.float32
    np.testing.assert_allclose(wt.numpy(), np.asarray(p_w), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(p_out), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("layout", ["row", "image"])
def test_attention_teacher_matches_eager_xla_bf16(tiny_cfg, tiny_params,
                                                  layout):
    """The training route in bf16, per-row and image-shared, against the
    JAX package's attention called eagerly (op by op) on bf16 streams."""
    cfg = _bf16_cfg(tiny_cfg)
    rng = np.random.RandomState(6)
    n, R, H = tiny_cfg.obj_num, tiny_cfg.rnn_size, tiny_cfg.att_hid_size
    S, G = 6, 3
    rows = S if layout == "row" else G
    h, p, a = (rng.uniform(-1, 1, (S, R)), rng.randn(rows, n, H) * 0.5,
               rng.rand(rows, n, R))
    mask = (rng.rand(S, n) > 0.5).astype("f")
    mask[:, 0] = 1.0
    jp = JD.cast_decoder_weights(
        jax.tree_util.tree_map(jnp.asarray, tiny_params[0]), cfg)
    pcfg = ModelConfig(**{k: getattr(cfg, k)
                          for k in ModelConfig.__dataclass_fields__})
    tp = D.cast_decoder_weights(params_from_numpy(
        jax.tree_util.tree_map(np.array, tiny_params[0]), "cpu"), pcfg)
    streams = {"att": a, "p_att": p} if layout == "row" else \
        {"att_img": a, "p_att_img": p}
    empty = dict(fc=None, att=None, p_att=None, fc_ih=None)
    j_f = JD.PreparedFeatures(**{**empty, "mask": jnp.asarray(mask), **{
        k: _bf(v)[1] for k, v in streams.items()}})
    t_f = D.PreparedFeatures(**{**empty, "mask": torch.from_numpy(mask), **{
        k: _bf(v)[0] for k, v in streams.items()}})
    j_out, j_w = JD.attention(jp, _bf(h)[1], j_f, cfg)
    out, wt = D.attention_teacher(tp, _bf(h)[0], t_f)
    assert out.dtype == wt.dtype == torch.float32
    np.testing.assert_allclose(wt.numpy(), np.asarray(j_w), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("bad", ["h_f32", "bh_bf16", "v_f32", "mask_bf16",
                                 "streams_f16"])
def test_bf16_wrappers_refuse_mixed_dtypes_on_cpu(tiny_cfg, tiny_params,
                                                  bad):
    """Every stream in one storage dtype and bh/bv/mask float32, or a
    TypeError before any arithmetic, on the CPU as on the card."""
    x = _inputs(tiny_cfg, "image", seed=7)
    wh, bh, v, bv = _weights(tiny_params)
    args = [_bf(x["h"])[0], _bf(x["p_att"])[0], _bf(x["att"])[0],
            torch.from_numpy(x["mask"]), torch.from_numpy(x["idx"]),
            _bf(wh)[0], torch.from_numpy(bh), _bf(v)[0], torch.from_numpy(bv)]
    A.shared_attention(*args)                   # the listed combination
    if bad == "h_f32":
        args[0] = args[0].float()
    elif bad == "bh_bf16":
        args[6] = args[6].to(torch.bfloat16)
    elif bad == "v_f32":
        args[7] = args[7].float()
    elif bad == "mask_bf16":
        args[3] = args[3].to(torch.bfloat16)
    else:
        for i in (0, 1, 2, 5, 7):
            args[i] = args[i].half()
    with pytest.raises(TypeError):
        A.shared_attention(*args)
    with pytest.raises(TypeError):
        A.row_attention(args[0][:, 0], *args[1:3],
                        args[3][:3], *args[5:])
    if bad in ("h_f32", "bh_bf16", "streams_f16"):
        with pytest.raises(TypeError):
            A.attention_project(args[0][:, 0], args[5], args[6])


def test_bf16_decoder_attention_on_cpu_is_the_plain_versions(tiny_cfg,
                                                             tiny_params):
    """``decoder.attention`` in the bf16 chain hands the wrappers bf16
    streams and weights (cast on the fly when the params are not), counts
    no launch on the CPU and returns float32."""
    cfg = ModelConfig(**{k: getattr(_bf16_cfg(tiny_cfg), k)
                         for k in ModelConfig.__dataclass_fields__})
    tp = params_from_numpy(jax.tree_util.tree_map(np.array, tiny_params[0]),
                           "cpu")
    x = _inputs(tiny_cfg, "subgraph", seed=8)
    feats = D.PreparedFeatures(fc=None, att=_bf(x["att"])[0],
                               p_att=_bf(x["p_att"])[0],
                               mask=torch.from_numpy(x["mask"]), fc_ih=None)
    A.reset_launch_counts()
    got = [D.attention(p, _bf(x["h"])[0], feats, cfg)
           for p in (tp, D.cast_decoder_weights(tp, cfg))]
    assert A.SHARED_BF16_LAUNCHES == A.PROJECT_LAUNCHES == 0
    want = _port_shared(x, _weights(tiny_params))
    for out, wt in got:
        assert out.dtype == wt.dtype == torch.float32
        torch.testing.assert_close(out, want[0], rtol=0, atol=0)
        torch.testing.assert_close(wt, want[1], rtol=0, atol=0)
