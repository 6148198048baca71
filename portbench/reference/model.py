"""Sub-GC and Full-GC in plain PyTorch: the yardstick the benchmark holds the
port to.

Written from the paper's reference (github.com/YiwuZhong/Sub-GC:
`models/AttModel.py`, `models/lib/gcn_backbone.py`, `models/lib/gpn.py`)
in plain tensor operations, float32, with no kernel, cache or batching
trick, and with nothing imported from the program.  It reads weights in the
benchmark's layout (``portbench/weights.py``): Linear weights ``[in, out]``
applied as ``x @ w + b``, LSTM gates stacked (i, f, g, o).

Where it departs from the reference's code, the result is the same by
construction:

* the GCN's scatter of relation messages onto nodes is ``index_add_``
  (the reference loops over images and relations);
* the masked attention softmax runs over each row's member nodes only,
  which equals the reference's softmax over every slot followed by the
  mask and the renormalisation;
* sub-graph NMS is the reference's sequential greedy loop, one image at a
  time (``decode.nms_keep``).

BatchNorm in training follows the semantics the port states
(``subgc_tpu_torch/models/encoder.py``): statistics over every padded row
of the batch, biased variance in the normalisation.
"""
from __future__ import annotations

import torch

F32 = torch.float32


def dense(x, p):
    return x @ p["w"] + p["b"]


# ---- encoder: fusion + GCN ------------------------------------------------

def fuse(w, cfg, obj_fmap, obj_dist, pred_dist):
    """Visual features fused with class word embeddings (AttModel.py:370-387).
    obj_fmap [B, N, F], obj_dist [B, N, C], pred_dist [B, K, P] ->
    (x_obj [B, N, L], x_pred [B, K, L])."""
    f = w["fusion"]
    x_obj = dense(obj_fmap, f["obj_v_proj"])
    if cfg["noun_fuse"]:
        cls = torch.argmax(obj_dist[..., 1:], dim=-1) + 1
        x_obj = torch.relu(x_obj + dense(f["obj_emb"][cls], f["obj_emb_proj"]))
    if cfg["pred_emb_type"] == 1:
        pcls = torch.argmax(pred_dist[..., 1:], dim=-1) + 1
    else:
        pcls = torch.argmax(pred_dist, dim=-1)
    return x_obj, dense(f["pred_emb"][pcls], f["pred_emb_proj"])


def batch_norm(x, p, s, train, eps=1e-5, momentum=0.1):
    """BatchNorm1d over the last axis; in training over every row of x.
    Returns (y, new running state)."""
    if not train:
        return (x - s["mean"]) / torch.sqrt(s["var"] + eps) * p["scale"] \
            + p["bias"], s
    flat = x.reshape(-1, x.shape[-1])
    m = flat.shape[0]
    mean = flat.mean(0)
    var = ((flat - mean) ** 2).mean(0)
    new = {"mean": ((1 - momentum) * s["mean"] + momentum * mean).detach(),
           "var": ((1 - momentum) * s["var"]
                   + momentum * var * m / max(m - 1, 1)).detach()}
    return (x - mean) / torch.sqrt(var + eps) * p["scale"] + p["bias"], new


def _scatter_mean(values, index, n_out):
    """values [B, M, L] summed onto rows index [B, M] of a [B, n_out, L]
    output, each row divided by its count (+1e-7)."""
    B, M, L = values.shape
    flat_ix = (index + n_out * torch.arange(B, device=index.device)[:, None]
               ).reshape(-1)
    out = torch.zeros((B * n_out, L), dtype=values.dtype,
                      device=values.device)
    out = out.index_add(0, flat_ix, values.reshape(-1, L))
    cnt = torch.zeros((B * n_out,), dtype=values.dtype, device=values.device)
    cnt = cnt.index_add(0, flat_ix,
                        torch.ones_like(flat_ix, dtype=values.dtype))
    return (out / (cnt[:, None] + 1e-7)).reshape(B, n_out, L)


def gcn(w, state, cfg, x_obj, x_pred, rel_ind, train=False):
    """Graph convolutions with periodic residuals (gcn_backbone.py:29-53,
    graph_conv_unit.py:28-36).  rel_ind [B, K, 2] (subject, object).
    Returns (x_obj, x_pred, new BatchNorm state)."""
    B, N, _ = x_obj.shape
    subj, obj = rel_ind[..., 0], rel_ind[..., 1]
    bix = torch.arange(B, device=x_obj.device)[:, None]
    res_obj, res_pred = x_obj, x_pred
    new_bn = []
    for i, units in enumerate(w["gcn"]):
        layer_bn = []

        def transform(x, u):
            h = dense(dense(x, units[u]["lft"]), units[u]["rgt"])
            if cfg["gcn_bn"]:
                h, s2 = batch_norm(h, units[u]["bn"], state["gcn_bn"][i][u],
                                   train)
            else:
                s2 = state["gcn_bn"][i][u]
            layer_bn.append(s2)
            return h

        h0 = transform(x_pred, 0)
        h1 = transform(x_pred, 1)
        h2 = transform(x_obj, 2)
        h3 = transform(x_obj, 3)
        o_s = torch.relu(_scatter_mean(h0, subj, N))
        o_o = torch.relu(_scatter_mean(h1, obj, N))
        # each relation reads its one subject / object node (degree 1)
        p_s = torch.relu(h2[bix, subj] / (1.0 + 1e-7))
        p_o = torch.relu(h3[bix, obj] / (1.0 + 1e-7))
        x_obj = (o_s + o_o) / 2
        x_pred = (p_s + p_o) / 2
        new_bn.append(layer_bn)
        if (i + 1) % cfg["gcn_residual"] == 0:
            x_obj = x_obj + res_obj
            res_obj = x_obj
            x_pred = x_pred + res_pred
            res_pred = x_pred
    return x_obj, x_pred, {**state, "gcn_bn": new_bn}


def encode(w, state, cfg, graph, train=False):
    """fusion -> GCN.  graph: dict of obj_fmap, obj_dist, rel_ind,
    pred_dist tensors [B, ...].  Returns (x_obj [B, N, L], new state)."""
    x_obj, x_pred = fuse(w, cfg, graph["obj_fmap"], graph["obj_dist"],
                         graph["pred_dist"])
    if cfg["gcn_layers"] == 0:
        return x_obj, state
    x_obj, _, state = gcn(w, state, cfg, x_obj, x_pred, graph["rel_ind"],
                          train)
    return x_obj, state


# ---- sGPN and NMS -----------------------------------------------------------

def pool_readout(x_nodes, mask):
    """Masked max + mean pooling (gpn.py:174-185): x_nodes [..., N, L]
    (post-GCN, >= 0), mask [..., N] -> [..., 2L]."""
    clean = x_nodes * mask[..., None]
    return torch.cat([clean.amax(-2),
                      clean.sum(-2) / mask.sum(-1, keepdim=True)], -1)


def sgpn_logits(w, read_out, keep=None):
    """The sGPN MLP (gpn.py:50-55); ``keep``: the training dropout mask of
    the hidden layer (keep with probability 0.5, scale 2)."""
    g = w["gpn"]
    h = torch.relu(dense(read_out, g["fc1"]))
    if keep is not None:
        h = torch.where(keep, h * 2.0, torch.zeros_like(h))
    return dense(h, g["fc2"])[..., 0]


def readout_project(w, read_out):
    g = w["gpn"]
    return dense(dense(read_out, g["readout1"]), g["readout2"])


def node_sets(obj_ind, att_mask, n_obj):
    """[S, N] indices + mask -> [S, n_obj] {0, 1} membership."""
    mem = torch.zeros((obj_ind.shape[0], n_obj), dtype=F32,
                      device=obj_ind.device)
    return mem.scatter_(1, obj_ind, att_mask).clamp_(max=1.0)


def pairwise_iou(mem):
    inter = mem @ mem.T
    size = mem.sum(-1)
    return inter / torch.clamp(size[:, None] + size[None, :] - inter, min=1)


# ---- decoder ----------------------------------------------------------------

def prepare(w, cfg, fc_feats, x_obj_rows, mask, drop=None):
    """fc_embed / att_embed / ctx2att (AttModel.py:356-368) for rows:
    fc_feats [S, 2L], x_obj_rows [S, N, L] the row's node features, mask
    [S, N].  ``drop(shape)`` gives the training dropout keep masks.
    Returns a dict of the decoder's per-row inputs."""
    d = w["decoder"]
    R = cfg["rnn_size"]
    fc = torch.relu(dense(torch.relu(dense(fc_feats, d["fc_embed1"])),
                          d["fc_embed2"]))
    if drop is not None:
        fc = drop(fc)
    att = torch.relu(dense(x_obj_rows, d["att_embed"]))
    if drop is not None:
        att = drop(att)
    return {"fc_ih": fc @ d["att_lstm"]["w_ih"][R:2 * R], "att": att,
            "p_att": dense(att, d["ctx2att"]), "mask": mask}


def lstm(p, gx, h, c):
    g = gx + h @ p["w_hh"] + p["b_hh"]
    i, f, gg, o = torch.chunk(g, 4, dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    return torch.sigmoid(o) * torch.tanh(c2), c2


def attend(w, h, feats):
    """Additive attention over each row's member nodes (AttModel.py:445-471).
    h [S, *, R]; feats' att / p_att [S, N, *], mask [S, N]."""
    d = w["decoder"]
    att_h = dense(h, d["h2att"])                              # [S, *, H]
    extra = h.dim() - 2
    p_att = feats["p_att"].reshape(feats["p_att"].shape[:1] + (1,) * extra
                                   + feats["p_att"].shape[1:])
    e = dense(torch.tanh(p_att + att_h[..., None, :]), d["alpha_net"])[..., 0]
    mask = feats["mask"].reshape(feats["mask"].shape[:1] + (1,) * extra
                                 + feats["mask"].shape[1:])
    e = e.masked_fill(mask == 0, float("-inf"))
    a = torch.softmax(e, dim=-1)                              # [S, *, N]
    att = feats["att"]
    if extra:
        return torch.einsum("sbn,snd->sbd", a, att)
    return torch.einsum("sn,snd->sd", a, att)


def step(w, cfg, state, xt_ih, feats, out_drop=None):
    """One decoder step from the word's att-LSTM gate share ``xt_ih``.
    state (h_att, c_att, h_lang, c_lang) [S, *, R].  Returns (logprobs,
    state)."""
    d = w["decoder"]
    R = cfg["rnn_size"]
    h_att, c_att, h_lang, c_lang = state
    fc_ih = feats["fc_ih"]
    if h_att.dim() == 3:
        fc_ih = fc_ih[:, None]
    wa = d["att_lstm"]
    gx = h_lang @ wa["w_ih"][:R] + fc_ih + xt_ih + wa["b_ih"]
    h_att, c_att = lstm(wa, gx, h_att, c_att)
    att_res = attend(w, h_att, feats)
    wl = d["lang_lstm"]
    gx = att_res @ wl["w_ih"][:R] + h_att @ wl["w_ih"][R:] + wl["b_ih"]
    h_lang, c_lang = lstm(wl, gx, h_lang, c_lang)
    out = h_lang if out_drop is None else out_drop(h_lang)
    return (torch.log_softmax(dense(out, d["logit"]), dim=-1),
            (h_att, c_att, h_lang, c_lang))


def word_ih(w, cfg, tokens):
    R = cfg["rnn_size"]
    d = w["decoder"]
    return torch.relu(d["embed"][tokens]) @ d["att_lstm"]["w_ih"][2 * R:]


def zero_state(shape, cfg, device):
    z = torch.zeros(tuple(shape) + (cfg["rnn_size"],), dtype=F32,
                    device=device)
    return (z, z, z, z)
