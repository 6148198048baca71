"""TopDown attention-LSTM decoder: inference and the teacher-forced training
forward, in float32 or in the bfloat16 chain.

The counterpart of ``subgc_tpu/models/decoder.py`` (reference
`models/AttModel.py:392-471`, training loop :157-175): att-LSTM -> additive
attention -> lang-LSTM -> logit -> log_softmax.  Decoder state and tokens
carry any leading shape; the beam search uses ``[S, bdash]`` (sub-graph,
beam), where the JAX package vmaps over sub-graphs.

:func:`decode_step` chooses one of three routes a step (:func:`_route`):

* ``autograd``: training, or a step that autograd needs a gradient
  through.  Attention is :func:`attention_teacher`, the JAX package's XLA
  attention written in torch ops, and the products are ``torch.matmul``,
  as the JAX package leaves them to XLA;
* ``kernels``: any step without a gradient (inference, and the val pass
  under ``torch.no_grad()``).  Attention goes through the hand-written,
  forward-only kernels in ``ops/attention.py`` (:func:`attention`; their
  plain versions on CPU tensors), the products through ``torch.matmul``;
* ``split``: a ``kernels`` step in float32 on the card with
  :data:`SPLIT_GEMM_MIN_ROWS` rows or more, whose seven products go
  through the split-TF32 tensor-core kernel (``ops/gemm.py``, float32
  accuracy), on weights split once a decode call (:class:`SplitWeights`).

The projections outside the step are plain ``torch.matmul`` on every
route.

Training draws every dropout mask and scheduled-sampling token from an
explicit ``torch.Generator``; without one there is no dropout.

``cfg.compute_dtype="bfloat16"`` is the JAX package's dtype chain, op for
op (``subgc_tpu/models/decoder.py``): parameters stay float32 masters and
:func:`cast_decoder_weights` casts the matmul weights once per call
(biases stay float32); a product of bf16 operands is rounded to bf16 and
then, unless kept (``_matmul(..., keep=True)``, the bf16 gate streams),
taken back to float32 to meet its bias; the LSTM state's ``h`` rides in
bf16 and ``c`` in float32; the node streams ``att``/``p_att`` are stored in
bf16 after their float32-biased projection.  ``bf16_lstm_gates`` also keeps
the [S, 4R] gate streams and their sigmoid/tanh in bf16.  Under autograd the
casts pass the gradients on to the float32 leaves.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import ModelConfig
from ..ops.attention import row_attention, shared_attention
from ..ops.gemm import prepare_weight, split_gemm
from ..parallel import distributed as DP
from .encoder import batch_norm_1d, batch_norm_1d_train
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


F32 = torch.float32


def init_state(shape, cfg: ModelConfig, device) -> DecoderState:
    """Zero state: ``h`` in the compute dtype (three matmuls re-read it each
    step), ``c`` in float32 (the accumulator)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    shape = shape + (cfg.rnn_size,)
    h = torch.zeros(shape, dtype=cfg.cdtype, device=device)
    c = h if cfg.cdtype == F32 else torch.zeros(shape, dtype=F32,
                                                 device=device)
    return DecoderState(h, c, h, c)


def _cast(w, dt):
    return w if w.dtype == dt else w.to(dt)


def _dense(x, p, dt=F32):
    """``x @ w + b``; in bf16 the product is rounded to bf16, then meets
    the float32 bias (JAX ``decoder.py:61-65``)."""
    if dt == F32:
        return x @ p["w"] + p["b"]
    return (_cast(x, dt) @ _cast(p["w"], dt)).float() + p["b"]


def _matmul(x, w, dt, keep=False):
    """``x @ w`` in the compute dtype: in bf16 the product is rounded to
    bf16 and, unless ``keep`` (the bf16 gate streams), taken back to
    float32 (JAX ``decoder.py:68-75``)."""
    if dt == F32:
        return x @ w
    y = _cast(x, dt) @ _cast(w, dt)
    return y if keep else y.float()


# decode_step's float32 products take the split-TF32 kernel from this many
# rows (the leading dims of the step's tokens) up.  Measured on an H100
# (chip_smoke.py's phase 28 sweep, PERF.md): from 1,000 rows the kernel's
# seven products of a step save more card time than its calls add host
# time (~25 us a call over torch's); below, at the beam decodes' 320 and
# 3 rows, torch.matmul is as fast or faster on the card, and cheaper to
# call.  The M-RNN greedy decode (1,000 rows an image) takes the kernel.
SPLIT_GEMM_MIN_ROWS = 1000


def _on_card(t) -> bool:
    return t.device.type == "cuda"


class SplitWeights:
    """The ``split`` route's weights for one decode call: each weight a
    product meets is prepared (``ops/gemm.py::prepare_weight``: its TF32
    halves, transposed) at its first use and reused by the call's later
    steps, since the seven weights serve every step.  A weight is known by
    its device, storage, shape and strides.  Each decode loop
    (``greedy.sample``, ``beam.beam_search``, :func:`forward_teacher`, the
    SCST rollout) makes its own and drops it when it returns, so nothing is
    kept across calls: a weight updated in place between calls is prepared
    again."""

    def __init__(self):
        self._prepared = {}

    def product(self, x, w, b=None):
        """``x @ w (+ b)`` through the split-TF32 kernel on ``w``'s
        prepared halves."""
        key = (w.device, w.data_ptr(), tuple(w.shape), w.stride())
        pw = self._prepared.get(key)
        if pw is None:
            pw = self._prepared[key] = prepare_weight(w)
        return split_gemm(x, pw, b)


def cast_decoder_weights(params, cfg: ModelConfig):
    """The decoder's matmul weights and the word-embedding table cast to
    the compute dtype once, before a decode or a teacher-forced pass, so
    that no step casts them again (JAX ``decoder.py:78-95``).  Biases stay
    float32 (they meet float32 sums), but for the LSTMs' under bf16 gates,
    which every step adds in bf16 (JAX casts them there each step, to the
    same values).  Float32 returns ``params`` itself.  Under autograd the
    casts carry the gradients to the float32 leaves."""
    dt = cfg.cdtype
    if dt == F32:
        return params
    dec = dict(params["decoder"])
    dec["embed"] = _cast(dec["embed"], dt)
    for k in ["fc_embed1", "fc_embed2", "att_embed", "ctx2att", "h2att",
              "alpha_net", "logit"]:
        dec[k] = {**dec[k], "w": _cast(dec[k]["w"], dt)}
    lstm = ("w", "b") if cfg.bf16_lstm_gates else ("w",)
    for k in ["att_lstm", "lang_lstm"]:
        dec[k] = {kk: _cast(v, dt) if kk.startswith(lstm) else v
                  for kk, v in dec[k].items()}
    return {**params, "decoder": dec}


def _dropout(x, rate, generator, train, axis: int = 0):
    """Inverted dropout with one mask entry per element: keep with
    probability ``1 - rate``, scale the kept by ``1 / (1 - rate)``.  Off at
    eval, at rate 0 and without a generator.  ``axis`` is the batch axis,
    along which a data-parallel rank keeps its rows of the global draw
    (``parallel.distributed.rand_rows``)."""
    if not train or rate == 0.0 or generator is None:
        return x
    keep = DP.rand_rows(x.shape, generator, x.device, axis=axis) \
        < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def draw_categorical(logits, generator, rows=None):
    """One categorical draw per row from unnormalised log-probabilities
    (Gumbel-max, as ``jax.random.categorical``); -inf entries are never
    drawn.

    ``rows=(at, total)``: these rows are rows ``at ..`` (an int), or rows
    ``at`` (an index tensor), of a ``total``-row batch, and the uniforms
    are drawn for all ``total`` rows and cut to these, so that a shard of
    a sharded decode, or a decode of the kept rows alone, draws what the
    decode of every row draws for them.  Under a data-parallel group the
    draw is the global batch's (``parallel.distributed.rand_rows``)."""
    if rows is not None:
        at, total = rows
        u = torch.rand((total,) + tuple(logits.shape[1:]),
                       generator=generator, dtype=logits.dtype,
                       device=logits.device)
        u = (u.index_select(0, at) if torch.is_tensor(at)
             else u[at:at + logits.shape[0]])
    else:
        u = DP.rand_rows(logits.shape, generator, logits.device,
                         dtype=logits.dtype)
    u = u.clamp(min=torch.finfo(logits.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _project_fc(params, fc_feats, cfg: ModelConfig, generator=None,
                train: bool = False):
    """fc_embed1/2 (with train dropout) and the precomputed att-LSTM w_ih
    slice for fc (fc is constant across decode steps)."""
    dec = params["decoder"]
    dt = cfg.cdtype
    fc = torch.relu(_dense(fc_feats, dec["fc_embed1"], dt))
    fc = torch.relu(_dense(fc, dec["fc_embed2"], dt))
    fc = _dropout(fc, cfg.drop_prob_lm, generator, train)
    R1 = cfg.rnn_size
    # kept in bf16 under bf16 gates (JAX decoder.py:341-342)
    fc_ih = _matmul(fc, dec["att_lstm"]["w_ih"][R1:2 * R1], dt,
                    keep=cfg.bf16_lstm_gates)
    return fc, fc_ih


def _bn_flat(x, p, s, train, mask):
    """BatchNorm over the last axis of ``x`` [..., C]: running statistics
    at eval; in training batch statistics over the flattened rows, masked
    by ``mask`` [...] (pack_wrapper).  Returns (y, new running state)."""
    if not train:
        return batch_norm_1d(x, p, s), s
    lead = x.shape[:-1]
    y, s2 = batch_norm_1d_train(x.reshape(-1, x.shape[-1]), p, s,
                                mask=mask.reshape(-1))
    return y.reshape(lead + (x.shape[-1],)), s2


def att_embed(params, att_feats, att_mask, cfg: ModelConfig,
              train: bool = False, generator=None, bn_state=None):
    """The att_embed Sequential (AttModel.py:114-119) with the pack_wrapper
    semantics (AttModel.py:28-37,364) of the JAX package's ``att_embed``:
    under ``use_bn`` BN0 over the input, Linear + ReLU (+ train dropout),
    BN1 when ``use_bn == 2``, and padded positions (``att_mask`` 0) exactly
    zero.  BatchNorm reads ``bn_state`` (``state["att_bn"]``) at eval; in
    training its statistics cover only the real rows.  att_feats [..., N,
    L], att_mask [..., N] -> (att [..., N, R], new bn_state)."""
    dec = params["decoder"]
    x = att_feats
    new_bn = bn_state
    if cfg.use_bn:
        if bn_state is None:
            raise ValueError("use_bn != 0 requires bn_state "
                             "(state['att_bn'] from init_params)")
        x, s0 = _bn_flat(x, dec["att_bn0"], bn_state["bn0"], train, att_mask)
        new_bn = {**bn_state, "bn0": s0}
    att = torch.relu(_dense(x, dec["att_embed"], cfg.cdtype))
    att = _dropout(att, cfg.drop_prob_lm, generator, train)
    if cfg.use_bn == 2:
        att, s1 = _bn_flat(att, dec["att_bn1"], new_bn["bn1"], train,
                           att_mask)
        new_bn = {**new_bn, "bn1": s1}
    if cfg.use_bn:
        # pad_packed_sequence zero-fills the padded rows
        att = att * att_mask[..., None]
    return att, new_bn


def prepare_features_bn(params, fc_feats, att_feats, att_mask,
                        cfg: ModelConfig, train: bool = False, generator=None,
                        bn_state=None):
    """fc_embed / att_embed / ctx2att over gathered node features
    (AttModel.py:356-368): fc_feats [S, 2L], att_feats [S, N, L], att_mask
    [S, N]; with train dropout and BatchNorm in train mode.  Returns (feats,
    new bn_state).  The layout of the training forward (one row per
    sentence over its chosen sub-graph's nodes) and of the Full-GC test
    path (one row per image over all of its nodes)."""
    fc, fc_ih = _project_fc(params, fc_feats, cfg, generator, train)
    att, new_bn = att_embed(params, att_feats, att_mask, cfg, train,
                            generator, bn_state)
    p_att = _dense(att, params["decoder"]["ctx2att"], cfg.cdtype)
    return PreparedFeatures(fc=fc, att=_cast(att, cfg.cdtype),
                            p_att=_cast(p_att, cfg.cdtype), mask=att_mask,
                            fc_ih=fc_ih), new_bn


def prepare_features_shared_train(params, fc_feats, x_obj, mem,
                                  cfg: ModelConfig, train: bool = False,
                                  generator=None) -> PreparedFeatures:
    """The training layout under ``share_att_train`` (JAX
    ``decoder.py:408-448``): the image node features x_obj [B, N, L] are
    projected once per image, and each row attends over its image's streams
    through its node-set membership mem [S, N].  Rows must group per image
    (labels are image-major).  att_embed dropout is drawn per image node,
    shared by the image's sentences, as in the JAX package.  Raises under
    ``use_bn``: train-time BatchNorm statistics cover the per-row layout."""
    if cfg.use_bn:
        raise ValueError(
            "share_att_train is incompatible with use_bn: train-time BN "
            "statistics cover the packed per-row layout")
    fc, fc_ih = _project_fc(params, fc_feats, cfg, generator, train)
    node_mask = torch.ones(x_obj.shape[:-1], dtype=mem.dtype,
                           device=mem.device)
    att_img, _ = att_embed(params, x_obj, node_mask, cfg, train, generator)
    p_att_img = _dense(att_img, params["decoder"]["ctx2att"], cfg.cdtype)
    return PreparedFeatures(fc=fc, att=None, p_att=None, mask=mem,
                            fc_ih=fc_ih, att_img=_cast(att_img, cfg.cdtype),
                            p_att_img=_cast(p_att_img, cfg.cdtype))


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
    ``ctx2att`` bias, as in :func:`prepare_features_bn`.
    """
    dec = params["decoder"]
    dt = cfg.cdtype
    fc, fc_ih = _project_fc(params, fc_feats, cfg)
    node_mask = torch.ones(x_obj_img.shape[:-1], dtype=att_mask.dtype,
                           device=att_mask.device)
    att_img, _ = att_embed(params, x_obj_img, node_mask, cfg,
                           bn_state=bn_state)
    p_att_img = _dense(att_img, dec["ctx2att"], dt)
    if image_shared:
        mem = node_membership(obj_ind, att_mask, x_obj_img.shape[-2])
        return PreparedFeatures(fc=fc, att=None, p_att=None, mask=mem,
                                fc_ih=fc_ih, att_img=_cast(att_img, dt),
                                p_att_img=_cast(p_att_img, dt))
    att = _gather_nodes(att_img, obj_ind)
    if cfg.use_bn:
        att = att * att_mask[..., None]
        p_att = _dense(att, dec["ctx2att"], dt)
    else:
        p_att = _gather_nodes(p_att_img, obj_ind)
    return PreparedFeatures(fc=fc, att=_cast(att, dt),
                            p_att=_cast(p_att, dt), mask=att_mask,
                            fc_ih=fc_ih)


def attention(params, h, feats: PreparedFeatures, cfg: ModelConfig):
    """Additive attention with post-softmax masking (AttModel.py:445-471).

    Every layout goes through a kernel wrapper (its plain version on CPU
    tensors).  Beam layouts (h [S, B, R], one feature set per sub-graph row
    shared by its B beams) take :func:`shared_attention`:

    * image-shared: ``att_img``/``p_att_img`` [G, n, *] with ``img_ix`` [S];
    * per-sub-graph: ``att``/``p_att`` [S, N, *], streams indexed by row.

    Per-row queries (h [S, R]; greedy and top-k):

    * image-shared fan-out (``att_img`` set): each row attends over its
      image's streams, ``img_ix`` [S] (or, without a map of every row, by
      position: K = S // G consecutive rows each, JAX
      ``decoder.py:488-526``);
      :func:`shared_attention` at one beam;
    * per-row streams (``att``/``p_att`` [S, N, *]; attention capture and
      grounding): :func:`row_attention`.

    The kernels take the streams' storage dtype: float32, or bfloat16 in
    the bf16 chain, where ``wh`` and ``v`` come cast (a no-op after
    :func:`cast_decoder_weights`).  Returns (att_res, weights), float32.
    """
    dec = params["decoder"]
    dt = (feats.p_att_img if feats.att_img is not None else feats.p_att).dtype
    wh, bh = _cast(dec["h2att"]["w"], dt), dec["h2att"]["b"]
    v, bv = _cast(dec["alpha_net"]["w"], dt), dec["alpha_net"]["b"]
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
        if feats.img_ix is not None and feats.img_ix.shape[0] == S:
            # the row -> image map: also right for a shard of the rows
            # that starts inside an image (a sub-graph-axis chunk)
            idx = feats.img_ix.to(torch.int32)
        else:
            # positional, as in the JAX package: rows are the images'
            # kept sub-graphs in order
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


def attention_teacher(params, h, feats: PreparedFeatures):
    """Additive attention with post-softmax masking in torch ops under
    autograd: the training route, the counterpart of the JAX package's XLA
    attention that ``jax.grad`` differentiates (``decoder.py:488-526``
    image-shared, ``:539-555`` per-row).  Not the kernels' plain versions
    (``ops/attention.py``), which stay what the kernels are held to.

    * per-row: h [S, R] over the row's own streams att/p_att [S, N, *];
    * image-shared (``att_img`` set): rows group per image by position, K =
      S // B consecutive rows each, over the images' [B, n, *] streams and
      the rows' membership mask [S, n].

    In the bf16 chain (bfloat16 streams) every op rounds as the XLA path's
    source does (the table in ``ops/attention.py``): the projection's
    product, then its biased sum, the add and the tanh in bf16, the logit
    product rounded before its float32 bias, softmax and renormalisation in
    float32, the weights rounded to bf16 for a float32-accumulated sum.

    Returns (att_res [S, D], weights [S, N]), float32.
    """
    dec = params["decoder"]
    if h.dim() != 2:
        raise ValueError("attention_teacher takes one query per row, h "
                         "[S, R]; the beam layouts decode under no_grad")
    dt = (feats.p_att_img if feats.att_img is not None else feats.p_att).dtype
    att_h = _cast(_dense(h, dec["h2att"], dt), dt)            # [S, H]

    def logits(dot):
        return _dense(dot, dec["alpha_net"], dt)[..., 0]

    def weighted(w, a):                 # float32 sums of the bf16 products
        return w @ a if dt == F32 else w.to(dt).float() @ a.float()

    if feats.att_img is not None:
        a, p = feats.att_img, feats.p_att_img
        if a.dim() == 2:                        # single-image layout
            a, p = a[None], p[None]
        B, n = a.shape[0], a.shape[1]
        S = h.shape[0]
        if S % B != 0:
            raise ValueError(
                f"image-shared attention needs rows grouped per image: "
                f"S={S} not divisible by B={B}")
        K = S // B
        dot = torch.tanh(p[:, None] + att_h.reshape(B, K, 1, -1))
        e = logits(dot)                                       # [B, K, n]
        w = torch.softmax(e, dim=-1)
        w = w * feats.mask.reshape(B, K, n)
        w = w / w.sum(-1, keepdim=True)
        return weighted(w, a).reshape(S, -1), w.reshape(S, n)
    dot = torch.tanh(feats.p_att + att_h[:, None, :])         # [S, N, H]
    e = logits(dot)                                           # [S, N]
    w = torch.softmax(e, dim=-1)
    w = w * feats.mask
    w = w / w.sum(-1, keepdim=True)
    return weighted(w[:, None, :], feats.att)[:, 0], w


def _sigmoid(x):
    """The logistic function; in bf16 as the JAX package's lowers on bf16
    operands, ``1 / (1 + exp(-x))`` with every op rounded to bf16 (one
    rounding of the float32 sigmoid differs in ~1/3 of the elements)."""
    if x.dtype == F32:
        return torch.sigmoid(x)
    return 1 / (1 + torch.exp(-x))


def _lstm_nonlin(g, c, dt=F32, bf16_gates=False):
    """LSTM cell nonlinearity on fully-formed gates g = gx + gh + biases
    (JAX ``decoder.py:142-157``).  Float32 gates: gate math and ``c`` in
    float32, the new ``h`` cast to the compute dtype.  Bf16 gates: sigmoid
    and tanh in bf16, ``c2 = f c + (i gg)`` in float32, ``h2`` rounded to
    bf16."""
    i, f, gg, o = torch.chunk(g, 4, dim=-1)
    i = _sigmoid(i)
    f = _sigmoid(f)
    o = _sigmoid(o)
    gg = torch.tanh(gg)
    if bf16_gates and dt != F32:
        c2 = f.float() * c + (i * gg).float()
        return (o.float() * torch.tanh(c2)).to(dt), c2
    c2 = f * c + i * gg
    h2 = o * torch.tanh(c2)
    return (h2 if dt == F32 else h2.to(dt)), c2


class _LSTMNonlinB16R(torch.autograd.Function):
    """:func:`_lstm_nonlin` with bfloat16 backward residuals
    (``cfg.bf16_residuals``; the JAX package's ``custom_vjp``
    ``_lstm_nonlin_b16r``, ``decoder.py:160-210``).  The forward IS
    ``_lstm_nonlin``, so it is bit-identical with the flag on or off; the
    backward keeps (g, c, c2) rounded to bfloat16 instead of autograd's five
    float32 activation streams and recomputes the elementwise derivatives
    from them."""

    @staticmethod
    def forward(ctx, g, c, dt=F32, bf16_gates=False):
        h2, c2 = _lstm_nonlin(g, c, dt, bf16_gates)
        ctx.g_dtype = g.dtype
        ctx.save_for_backward(g.to(torch.bfloat16), c.to(torch.bfloat16),
                              c2.to(torch.bfloat16))
        return h2, c2

    @staticmethod
    def backward(ctx, dh2, dc2):
        g, c, c2 = (t.float() for t in ctx.saved_tensors)
        dh2, dc2 = dh2.float(), dc2.float()
        gi, gf, gg_, go = torch.chunk(g, 4, dim=-1)
        i = torch.sigmoid(gi)
        f = torch.sigmoid(gf)
        o = torch.sigmoid(go)
        gg = torch.tanh(gg_)
        tc2 = torch.tanh(c2)
        do = dh2 * tc2
        dc = dc2 + dh2 * o * (1.0 - tc2 * tc2)
        dg = torch.cat([dc * gg * (i * (1.0 - i)),       # d/d gi
                        dc * c * (f * (1.0 - f)),        # d/d gf
                        dc * i * (1.0 - gg * gg),        # d/d gg
                        do * (o * (1.0 - o))], dim=-1)   # d/d go
        # dg in the gate streams' dtype (bf16 under bf16 gates), as the
        # JAX vjp returns it (decoder.py:206-207)
        return dg.to(ctx.g_dtype), dc * f, None, None


def _lstm_gates(product, p, gx, h, dt=F32, bf16_gates: bool = False):
    """An LSTM's gates: the input share ``gx`` (x @ w_ih + b_ih) plus the
    recurrent product through the route's ``product`` and ``b_hh`` (JAX
    ``_lstm_cell_gx``, ``decoder.py:225-244``).  Bf16 gates (bf16 compute
    dtype): ``gx`` is bf16, and the product and then ``b_hh`` join it in
    bf16; otherwise ``gx + (h @ w_hh + b_hh)``."""
    if bf16_gates:
        return gx + product(h, p["w_hh"]) + _cast(p["b_hh"], dt)
    return gx + product(h, p["w_hh"], p["b_hh"])


def _leaves(tree):
    """The tensors of a nested dict."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _route(params, state, token, feats, cfg: ModelConfig, train,
           xt_ih=None) -> str:
    """:func:`decode_step`'s route (the module docstring): ``"autograd"``
    in training, or where grad mode is on and one of the step's inputs
    requires grad (the state, ``xt_ih``, a field of ``feats``, a leaf of
    the decoder); else ``"split"`` where the compute dtype is float32 (the
    bf16 chain's products already run on the tensor cores), the tokens are
    on the card and the step has :data:`SPLIT_GEMM_MIN_ROWS` rows or more;
    else ``"kernels"``."""
    if train or (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (*state, xt_ih, *feats, *_leaves(params["decoder"])))):
        return "autograd"
    if (cfg.cdtype == F32 and _on_card(token)
            and token.numel() >= SPLIT_GEMM_MIN_ROWS):
        return "split"
    return "kernels"


def _product(route: str, dt, bf16_gates: bool, split=None):
    """The route's product ``(x, w, b=None) -> x @ w`` (+ ``b``): the
    split-TF32 kernel on ``split``'s prepared weights, ``b`` joining in its
    epilogue, on the ``split`` route (a new :class:`SplitWeights` where
    ``split`` is None); otherwise torch's, rounded in the compute dtype
    (and kept in bf16 under bf16 gates) by :func:`_matmul`, or with ``b``
    the biased :func:`_dense`."""
    if route == "split":
        return (split if split is not None else SplitWeights()).product

    def product(x, w, b=None):
        if b is None:
            return _matmul(x, w, dt, keep=bf16_gates)
        return _dense(x, {"w": w, "b": b}, dt)
    return product


def decode_step(params, state: DecoderState, token,
                feats: PreparedFeatures, cfg: ModelConfig,
                train: bool = False, generator=None, xt_ih=None,
                split: Optional[SplitWeights] = None):
    """One decoder step.  token [...] int -> (logprobs [..., V+1], state,
    att weights).  With a beam axis (token [S, B]) each sub-graph's features
    are shared by its beams.

    In training (``train``), dropout from ``generator`` falls on the word
    embedding and on the lang-LSTM output before the logit, and
    ``cfg.bf16_residuals`` selects the bfloat16-residual LSTM backward.
    ``xt_ih`` is the word embedding's precomputed att-LSTM gate share
    [S, 4R] (:func:`forward_teacher` hoists all T of them).  ``split``: the
    decode call's :class:`SplitWeights`, which the ``split`` route's
    products read their weights from; a loop of steps passes one to every
    step (without it the step prepares its own).

    The step's route (:func:`_route`, once a step) chooses the attention,
    :func:`attention_teacher` on the ``autograd`` route and the kernels
    (:func:`attention`) otherwise, and the product (:func:`_product`) that
    forms each of its seven products: the att-LSTM's word, ``h_lang`` and
    recurrent ones, the lang-LSTM's ``att_res``, ``h_att`` and recurrent
    ones, the logit.  On the ``split`` route the recurrent and logit
    biases join in the kernel's epilogue, with the one float32 rounding of
    ``x @ w + b``; torch's routes keep the sums ``gx + (h @ w_hh + b_hh)``
    and ``out @ w + b``.

    In the bf16 chain the products round as JAX ``decode_step``'s do
    (``decoder.py:558-639``); under ``bf16_lstm_gates`` ``fc_ih``, the
    input biases and ``xt_ih`` join the gates in bf16.  Callers cast the
    weights once (:func:`cast_decoder_weights`); uncast ones are cast per
    product, to the same values."""
    dec = params["decoder"]
    dt = cfg.cdtype
    R1 = cfg.rnn_size
    bf16g = cfg.bf16_lstm_gates and dt != F32
    route = _route(params, state, token, feats, cfg, train, xt_ih)
    mm = _product(route, dt, bf16g, split)
    cell = (_LSTMNonlinB16R.apply if cfg.bf16_residuals and train
            else _lstm_nonlin)
    w_ih = dec["att_lstm"]["w_ih"]
    b_ih_a = dec["att_lstm"]["b_ih"]
    fc_ih = feats.fc_ih if token.dim() == 1 else feats.fc_ih[:, None, :]
    if bf16g:
        b_ih_a = _cast(b_ih_a, dt)
        fc_ih = _cast(fc_ih, dt)
    if xt_ih is None:
        xt = torch.relu(dec["embed"][token])
        xt = _dropout(xt, cfg.drop_prob_lm, generator, train)
        xt_ih = mm(xt, w_ih[2 * R1:])
    gx_att = mm(state.h_lang, w_ih[:R1]) + fc_ih + xt_ih + b_ih_a
    h_att, c_att = cell(_lstm_gates(mm, dec["att_lstm"], gx_att, state.h_att,
                                    dt, bf16g), state.c_att, dt, bf16g)

    if route == "autograd":
        att_res, att_w = attention_teacher(params, h_att, feats)
    else:
        att_res, att_w = attention(params, h_att, feats, cfg)

    w_ih_l = dec["lang_lstm"]["w_ih"]
    b_ih_l = dec["lang_lstm"]["b_ih"]
    if bf16g:
        b_ih_l = _cast(b_ih_l, dt)
    gx_lang = mm(att_res, w_ih_l[:R1]) + mm(h_att, w_ih_l[R1:]) + b_ih_l
    h_lang, c_lang = cell(_lstm_gates(mm, dec["lang_lstm"], gx_lang,
                                      state.h_lang, dt, bf16g),
                          state.c_lang, dt, bf16g)
    out = _dropout(h_lang, cfg.drop_prob_lm, generator, train)
    logits = mm(out, dec["logit"]["w"], dec["logit"]["b"])
    logprobs = torch.log_softmax(logits, dim=-1)
    return logprobs, DecoderState(h_att, c_att, h_lang, c_lang), att_w


def forward_teacher(params, feats: PreparedFeatures, seq, cfg: ModelConfig,
                    train: bool = False, generator=None, ss_prob=None):
    """Teacher-forced forward over a [S, T+2] label tensor
    (AttModel.py:157-175): logprobs [S, T+1, V+1] for predicting
    ``seq[:, 1:]``.

    ``ss_prob is None`` (scheduled sampling off, and every val pass): all T
    input tokens are known up front, so the word embeddings' att-LSTM gate
    products are hoisted out of the step loop as one [T*S, E] x [E, 4R]
    matmul (their dropout masks drawn first).  Otherwise, in training, the
    input token of each row at step i >= 1 is, with probability
    ``ss_prob``, a draw from the previous step's distribution; the draws
    come from ``generator`` (a generator seeded with 0 when none is
    given, which then also means no dropout).

    The weights are cast to the compute dtype once, here; under bf16 gates
    the hoisted products stay in bf16 (JAX ``decoder.py:691-693``).
    """
    params = cast_decoder_weights(params, cfg)
    S, T2 = seq.shape
    n_steps = T2 - 1
    dec = params["decoder"]
    dev = seq.device
    state = init_state(S, cfg, dev)
    split = SplitWeights()
    lps = []
    if ss_prob is None:
        R1 = cfg.rnn_size
        dt = cfg.cdtype
        xt = torch.relu(dec["embed"][seq[:, :n_steps].T])      # [T, S, E]
        xt = _dropout(xt, cfg.drop_prob_lm, generator, train, axis=1)
        xt_ih = _matmul(xt.reshape(n_steps * S, -1),
                        dec["att_lstm"]["w_ih"][2 * R1:], dt,
                        keep=cfg.bf16_lstm_gates and dt != F32
                        ).reshape(n_steps, S, -1)
        for i in range(n_steps):
            lp, state, _ = decode_step(params, state, seq[:, i], feats, cfg,
                                       train, generator, xt_ih=xt_ih[i],
                                       split=split)
            lps.append(lp)
        return torch.stack(lps, 1)
    ss_gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    for i in range(n_steps):
        token = seq[:, i]
        if train and i >= 1:
            use = DP.rand_rows((S,), ss_gen, dev) < ss_prob
            sampled = draw_categorical(lps[-1].detach(), ss_gen)
            token = torch.where(use, sampled, token)
        lp, state, _ = decode_step(params, state, token, feats, cfg, train,
                                   generator, split=split)
        lps.append(lp)
    return torch.stack(lps, 1)
