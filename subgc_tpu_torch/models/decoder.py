"""TopDown attention-LSTM decoder, inference only, float32.

The counterpart of ``subgc_tpu/models/decoder.py`` (reference
`models/AttModel.py:392-471`): att-LSTM -> additive attention -> lang-LSTM ->
logit -> log_softmax.  Decoder state and tokens carry any leading shape; the
beam search uses ``[S, bdash]`` (sub-graph, beam), where the JAX package
vmaps over sub-graphs.  The LSTM, logit and projection products are plain
``torch.matmul``, as the JAX package leaves them to XLA; the beam layouts'
attention goes through the hand-written kernel in ``ops/attention.py``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import ModelConfig
from ..ops.attention import shared_attention
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


def att_embed(params, att_feats, cfg: ModelConfig):
    """The att_embed Sequential (AttModel.py:114-119) at eval with use_bn=0."""
    if cfg.use_bn:
        raise NotImplementedError("att_embed BatchNorm (use_bn) is not "
                                  "ported yet")
    return torch.relu(_dense(att_feats, params["decoder"]["att_embed"]))


def _gather_nodes(x_img, ind):
    """x_img [..., n_obj, F], ind [..., K, N] -> [..., K, N, F]."""
    if x_img.dim() == 2:
        return x_img[ind]
    b = torch.arange(x_img.shape[0], device=x_img.device)
    return x_img[b.view(-1, *([1] * (ind.dim() - 1))), ind]


def prepare_features_nodes(params, fc_feats, x_obj_img, obj_ind, att_mask,
                           cfg: ModelConfig,
                           image_shared: bool = False) -> PreparedFeatures:
    """Eval-path feature preparation that projects the image's node features
    once and then gathers the projected rows per sub-graph.

    fc_feats [..., K, 2L] read-outs of the kept sub-graphs; x_obj_img
    [..., n_obj, L]; obj_ind/att_mask [..., K, N].  The leading axis, if
    any, is the image; rows keep it (flatten with the caller).

    image_shared=True keeps the image-level streams and a membership mask
    (attention then reads ``[images, n_obj, *]`` instead of per-row copies);
    otherwise the per-row gathered ``[K, N, *]`` layout.
    """
    require_float32(cfg)
    fc, fc_ih = _project_fc(params, fc_feats, cfg)
    att_img = att_embed(params, x_obj_img, cfg)
    p_att_img = _dense(att_img, params["decoder"]["ctx2att"])
    if image_shared:
        mem = node_membership(obj_ind, att_mask, x_obj_img.shape[-2])
        return PreparedFeatures(fc=fc, att=None, p_att=None, mask=mem,
                                fc_ih=fc_ih, att_img=att_img,
                                p_att_img=p_att_img)
    return PreparedFeatures(fc=fc, att=_gather_nodes(att_img, obj_ind),
                            p_att=_gather_nodes(p_att_img, obj_ind),
                            mask=att_mask, fc_ih=fc_ih)


def attention(params, h, feats: PreparedFeatures, cfg: ModelConfig):
    """Additive attention with post-softmax masking (AttModel.py:445-471).

    Beam layouts (h [S, B, R], one feature set per sub-graph row shared by
    its B beams) go through the kernel wrapper:

    * image-shared: ``att_img``/``p_att_img`` [G, n, *] with ``img_ix`` [S];
    * per-sub-graph: ``att``/``p_att`` [S, N, *], streams indexed by row.

    The per-row layout (h [S, R], att [S, N, R]; attention capture and
    grounding) stays plain torch for now.  Returns (att_res, weights).
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
        raise NotImplementedError("image-shared attention over per-row "
                                  "queries (the greedy fan-out) is not "
                                  "ported yet")
    att_h = _dense(h, dec["h2att"])                           # [S, H]
    dot = torch.tanh(feats.p_att + att_h[:, None, :])         # [S, N, H]
    e = _dense(dot, dec["alpha_net"])[..., 0]                 # [S, N]
    w = torch.softmax(e, dim=-1)
    w = w * feats.mask
    w = w / w.sum(-1, keepdim=True)
    att_res = (w[:, None, :] @ feats.att)[:, 0]
    return att_res, w


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
