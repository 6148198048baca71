"""TopDown attention-LSTM decoder, inference only, float32.

The counterpart of ``subgc_tpu/models/decoder.py`` (reference
`models/AttModel.py:392-471`): att-LSTM -> additive attention -> lang-LSTM ->
logit -> log_softmax.  Decoder state and tokens carry any leading shape; the
beam search uses ``[S, bdash]`` (sub-graph, beam), where the JAX package
vmaps over sub-graphs.  The LSTM, logit and projection products are plain
``torch.matmul``, as the JAX package leaves them to XLA; attention goes
through the hand-written kernels in ``ops/attention.py`` in every layout.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import ModelConfig
from ..ops.attention import row_attention, shared_attention
from .encoder import batch_norm_1d
from .gpn import node_membership


class DecoderState(NamedTuple):
    h_att: torch.Tensor   # [..., R]
    c_att: torch.Tensor
    h_lang: torch.Tensor
    c_lang: torch.Tensor


class PreparedFeatures(NamedTuple):
    fc: torch.Tensor                 # [S, R]    embedded read-out feature
    att: Optional[torch.Tensor]      # [S, N, R] embedded node features
    p_att: Optional[torch.Tensor]    # [S, N, H] pre-projected for attention
    mask: torch.Tensor               # [S, N], or [S, n_obj] membership
    fc_ih: torch.Tensor              # [S, 4R]   fc's att-LSTM gate share
    # image-shared layout: att/p_att are None, the streams are per image and
    # mask is each row's node-set membership over its image's nodes
    att_img: Optional[torch.Tensor] = None     # [G, n_obj, R]
    p_att_img: Optional[torch.Tensor] = None   # [G, n_obj, H]
    img_ix: Optional[torch.Tensor] = None      # [S] row -> image


def init_state(shape, cfg: ModelConfig, device) -> DecoderState:
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    z = torch.zeros(shape + (cfg.rnn_size,), dtype=torch.float32,
                    device=device)
    return DecoderState(z, z, z, z)


def _dense(x, p):
    return x @ p["w"] + p["b"]


def require_float32(cfg: ModelConfig):
    if cfg.cdtype != torch.float32:
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r}: the port runs float32 only")


def _project_fc(params, fc_feats, cfg: ModelConfig):
    """fc_embed1/2 and the precomputed att-LSTM w_ih slice for fc (fc is
    constant across decode steps)."""
    dec = params["decoder"]
    fc = torch.relu(_dense(fc_feats, dec["fc_embed1"]))
    fc = torch.relu(_dense(fc, dec["fc_embed2"]))
    R1 = cfg.rnn_size
    fc_ih = fc @ dec["att_lstm"]["w_ih"][R1:2 * R1]
    return fc, fc_ih


def att_embed(params, att_feats, att_mask, cfg: ModelConfig, bn_state=None):
    """The att_embed Sequential (AttModel.py:114-119) at eval, with the
    pack_wrapper semantics (AttModel.py:28-37,364) of the JAX package's
    ``att_embed``: under ``use_bn`` BN0 over the input, Linear + ReLU, BN1
    when ``use_bn == 2``, and padded positions (``att_mask`` 0) exactly
    zero.  BatchNorm reads its running statistics from ``bn_state``
    (``state["att_bn"]``).  att_feats [..., N, L], att_mask [..., N] ->
    [..., N, R]."""
    dec = params["decoder"]
    x = att_feats
    if cfg.use_bn:
        if bn_state is None:
            raise ValueError("use_bn != 0 requires bn_state "
                             "(state['att_bn'] from init_params)")
        x = batch_norm_1d(x, dec["att_bn0"], bn_state["bn0"])
    att = torch.relu(_dense(x, dec["att_embed"]))
    if cfg.use_bn == 2:
        att = batch_norm_1d(att, dec["att_bn1"], bn_state["bn1"])
    if cfg.use_bn:
        # pad_packed_sequence zero-fills the padded rows
        att = att * att_mask[..., None]
    return att


def prepare_features(params, fc_feats, att_feats, att_mask, cfg: ModelConfig,
                     bn_state=None) -> PreparedFeatures:
    """fc_embed / att_embed / ctx2att over gathered node features
    (AttModel.py:356-368): fc_feats [S, 2L], att_feats [S, N, L], att_mask
    [S, N].  The Full-GC test path's layout: one row per image over all of
    its nodes."""
    require_float32(cfg)
    fc, fc_ih = _project_fc(params, fc_feats, cfg)
    att = att_embed(params, att_feats, att_mask, cfg, bn_state)
    p_att = _dense(att, params["decoder"]["ctx2att"])
    return PreparedFeatures(fc=fc, att=att, p_att=p_att, mask=att_mask,
                            fc_ih=fc_ih)


def _gather_nodes(x_img, ind):
    """x_img [..., n_obj, F], ind [..., K, N] -> [..., K, N, F]."""
    if x_img.dim() == 2:
        return x_img[ind]
    b = torch.arange(x_img.shape[0], device=x_img.device)
    return x_img[b.view(-1, *([1] * (ind.dim() - 1))), ind]


def prepare_features_nodes(params, fc_feats, x_obj_img, obj_ind, att_mask,
                           cfg: ModelConfig, bn_state=None,
                           image_shared: bool = False) -> PreparedFeatures:
    """Eval-path feature preparation that projects the image's node features
    once and then gathers the projected rows per sub-graph.

    fc_feats [..., K, 2L] read-outs of the kept sub-graphs; x_obj_img
    [..., n_obj, L]; obj_ind/att_mask [..., K, N].  The leading axis, if
    any, is the image; rows keep it (flatten with the caller).

    image_shared=True keeps the image-level streams and a membership mask
    (attention then reads ``[images, n_obj, *]`` instead of per-row copies;
    the membership mask subsumes the ``use_bn`` zero-fill); otherwise the
    per-row gathered ``[K, N, *]`` layout, where under ``use_bn`` the
    zero-fill comes before ``ctx2att``, so a padded slot's ``p_att`` is the
    ``ctx2att`` bias, as in :func:`prepare_features`.
    """
    require_float32(cfg)
    dec = params["decoder"]
    fc, fc_ih = _project_fc(params, fc_feats, cfg)
    node_mask = torch.ones(x_obj_img.shape[:-1], dtype=att_mask.dtype,
                           device=att_mask.device)
    att_img = att_embed(params, x_obj_img, node_mask, cfg, bn_state)
    p_att_img = _dense(att_img, dec["ctx2att"])
    if image_shared:
        mem = node_membership(obj_ind, att_mask, x_obj_img.shape[-2])
        return PreparedFeatures(fc=fc, att=None, p_att=None, mask=mem,
                                fc_ih=fc_ih, att_img=att_img,
                                p_att_img=p_att_img)
    att = _gather_nodes(att_img, obj_ind)
    if cfg.use_bn:
        att = att * att_mask[..., None]
        p_att = _dense(att, dec["ctx2att"])
    else:
        p_att = _gather_nodes(p_att_img, obj_ind)
    return PreparedFeatures(fc=fc, att=att, p_att=p_att, mask=att_mask,
                            fc_ih=fc_ih)


def attention(params, h, feats: PreparedFeatures, cfg: ModelConfig):
    """Additive attention with post-softmax masking (AttModel.py:445-471).

    Every layout goes through a kernel wrapper (its plain version on CPU
    tensors).  Beam layouts (h [S, B, R], one feature set per sub-graph row
    shared by its B beams) take :func:`shared_attention`:

    * image-shared: ``att_img``/``p_att_img`` [G, n, *] with ``img_ix`` [S];
    * per-sub-graph: ``att``/``p_att`` [S, N, *], streams indexed by row.

    Per-row queries (h [S, R]; greedy and top-k):

    * image-shared fan-out (``att_img`` set): rows group per image by
      position, K = S // G consecutive rows each (JAX ``decoder.py:488-526``);
      :func:`shared_attention` at one beam;
    * per-row streams (``att``/``p_att`` [S, N, *]; attention capture and
      grounding): :func:`row_attention`.

    Returns (att_res, weights).
    """
    dec = params["decoder"]
    wh, bh = dec["h2att"]["w"], dec["h2att"]["b"]
    v, bv = dec["alpha_net"]["w"], dec["alpha_net"]["b"]
    if h.dim() == 3:
        if feats.att_img is not None:
            p, a, idx = feats.p_att_img, feats.att_img, feats.img_ix
        else:
            p, a = feats.p_att, feats.att
            idx = torch.arange(p.shape[0], device=p.device)
        return shared_attention(h.contiguous(), p.contiguous(),
                                a.contiguous(), feats.mask.contiguous(),
                                idx.to(torch.int32), wh, bh, v, bv)
    if feats.att_img is not None:
        a, p = feats.att_img, feats.p_att_img
        if a.dim() == 2:                        # single-image layout
            a, p = a[None], p[None]
        G, S = a.shape[0], h.shape[0]
        # the grouping is positional and ignores img_ix, as in the JAX
        # package: rows are the images' kept sub-graphs in order
        if S % G != 0:
            raise ValueError(
                f"image-shared attention needs rows grouped per image: "
                f"S={S} not divisible by B={G}")
        idx = torch.arange(G, dtype=torch.int32,
                           device=h.device).repeat_interleave(S // G)
        out, w = shared_attention(h[:, None, :].contiguous(), p.contiguous(),
                                  a.contiguous(), feats.mask.contiguous(),
                                  idx, wh, bh, v, bv)
        return out[:, 0], w[:, 0]
    return row_attention(h.contiguous(), feats.p_att.contiguous(),
                         feats.att.contiguous(), feats.mask.contiguous(),
                         wh, bh, v, bv)


def _lstm_nonlin(g, c):
    """LSTM cell nonlinearity on fully-formed gates g = gx + gh + biases."""
    i, f, gg, o = torch.chunk(g, 4, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f)
    o = torch.sigmoid(o)
    gg = torch.tanh(gg)
    c2 = f * c + i * gg
    return o * torch.tanh(c2), c2


def _lstm_cell_gx(p, gx, h, c):
    """LSTM cell with the input-side gates (x @ w_ih + b_ih) precomputed."""
    return _lstm_nonlin(gx + (h @ p["w_hh"] + p["b_hh"]), c)


def decode_step(params, state: DecoderState, token,
                feats: PreparedFeatures, cfg: ModelConfig):
    """One decoder step at eval.  token [...] int -> (logprobs [..., V+1],
    state, att weights).  With a beam axis (token [S, B]) each sub-graph's
    features are shared by its beams."""
    dec = params["decoder"]
    R1 = cfg.rnn_size
    w_ih = dec["att_lstm"]["w_ih"]
    fc_ih = feats.fc_ih if token.dim() == 1 else feats.fc_ih[:, None, :]
    xt = torch.relu(dec["embed"][token])
    xt_ih = xt @ w_ih[2 * R1:]
    gx_att = (state.h_lang @ w_ih[:R1] + fc_ih + xt_ih
              + dec["att_lstm"]["b_ih"])
    h_att, c_att = _lstm_cell_gx(dec["att_lstm"], gx_att, state.h_att,
                                 state.c_att)

    att_res, att_w = attention(params, h_att, feats, cfg)

    w_ih_l = dec["lang_lstm"]["w_ih"]
    gx_lang = (att_res @ w_ih_l[:R1] + h_att @ w_ih_l[R1:]
               + dec["lang_lstm"]["b_ih"])
    h_lang, c_lang = _lstm_cell_gx(dec["lang_lstm"], gx_lang, state.h_lang,
                                   state.c_lang)
    logprobs = torch.log_softmax(_dense(h_lang, dec["logit"]), dim=-1)
    return logprobs, DecoderState(h_att, c_att, h_lang, c_lang), att_w
