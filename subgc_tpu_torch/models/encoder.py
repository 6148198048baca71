"""Scene-graph encoder: feature fusion + GCN backbone (Sub-GC variant).

The counterpart of ``subgc_tpu/models/encoder.py``: the node/relation
adjacency is one one-hot comparison instead of the reference's per-image
scatter loop (`models/lib/gcn_backbone.py:55-67`), and message passing is
two matmuls per collection unit (`graph_conv_unit.py:28-36`), with the
Full-GC variant's BatchNorm at eval between them and the adjacency product.
"""
from __future__ import annotations

import torch

from ..config import ModelConfig


def batch_norm_1d(x, p, s, eps: float = 1e-5):
    """torch.nn.BatchNorm1d at eval over the last axis: running statistics
    ``s`` {mean, var}, affine ``p`` {scale, bias}.  Written in the JAX
    package's order, ``(x - mean) * rsqrt(var + eps) * scale + bias``, which
    ``F.batch_norm`` does not keep."""
    return (x - s["mean"]) * torch.rsqrt(s["var"] + eps) * p["scale"] \
        + p["bias"]


def _dense(x, p):
    return x @ p["w"] + p["b"]


def one_hot(ind, n: int):
    """[...] int -> [..., n] float32 one-hot built by comparison, so an index
    outside [0, n) gives a zero row as ``jax.nn.one_hot`` does (where
    ``F.one_hot`` would raise)."""
    ar = torch.arange(n, device=ind.device)
    return (ind[..., None] == ar).to(torch.float32)


def fuse_features(params, graph_obj_dist, obj_fmap, pred_dist,
                  cfg: ModelConfig):
    """Fuse visual features with class word embeddings (AttModel.py:370-387).

    Returns (x_obj [B,N,L], x_pred [B,K,L]).
    """
    f = params["fusion"]
    x_obj = _dense(obj_fmap, f["obj_v_proj"])
    if cfg.noun_fuse:
        # hard argmax over non-background classes, shifted past background
        # (torch.argmax and jnp.argmax both take the first maximum on ties)
        cls = torch.argmax(graph_obj_dist[..., 1:], dim=-1) + 1
        emb = _dense(f["obj_emb"][cls], f["obj_emb_proj"])
        x_obj = torch.relu(x_obj + emb)

    if cfg.pred_emb_type == 1:       # argmax excluding background
        pcls = torch.argmax(pred_dist[..., 1:], dim=-1) + 1
    elif cfg.pred_emb_type == 2:     # argmax including background
        pcls = torch.argmax(pred_dist, dim=-1)
    else:
        raise ValueError(f"pred_emb_type {cfg.pred_emb_type}")
    x_pred = _dense(f["pred_emb"][pcls], f["pred_emb_proj"])
    return x_obj, x_pred


def make_adjacency(rel_ind, n_obj: int):
    """rel_ind [B,K,2] -> (adj_s, adj_o) each [B,N,K] with adj[b,n,k] = 1 iff
    relation k has node n as its subject/object."""
    adj_s = one_hot(rel_ind[..., 0], n_obj)
    adj_o = one_hot(rel_ind[..., 1], n_obj)
    return adj_s.transpose(1, 2), adj_o.transpose(1, 2)


def _collect(source, adj, unit, ustate):
    """One collection unit: low-rank transform of source, BatchNorm if the
    unit has one, adjacency average (graph_conv_unit.py:28-36).  adj is
    [B,T,S], source [B,S,L]."""
    h = _dense(_dense(source, unit["lft"]), unit["rgt"])
    if "bn" in unit:
        h = batch_norm_1d(h, unit["bn"], ustate)
    collect = adj @ h
    degree = adj.sum(2)[..., None]
    return torch.relu(collect / (degree + 1e-7))


def gcn_forward(params, state, x_obj, x_pred, rel_ind, cfg: ModelConfig):
    """Stacked graph convolutions with periodic residuals
    (gcn_backbone.py:29-53), eval mode: BatchNorm units read their running
    statistics from ``state["gcn_bn"][layer][unit]``.

    Returns (x_obj [B,N,L], x_pred [B,K,L], state).
    """
    if cfg.gcn_layers == 0:
        return x_obj, x_pred, state

    adj_s, adj_o = make_adjacency(rel_ind, x_obj.shape[1])
    adj_s_t = adj_s.transpose(1, 2)
    adj_o_t = adj_o.transpose(1, 2)

    res_obj, res_pred = x_obj, x_pred
    for i, units in enumerate(params["gcn"]):
        us = state["gcn_bn"][i]
        # both node and edge updates read the *input* features of this layer
        o_from_s = _collect(x_pred, adj_s, units[0], us[0])
        o_from_o = _collect(x_pred, adj_o, units[1], us[1])
        p_from_s = _collect(x_obj, adj_s_t, units[2], us[2])
        p_from_o = _collect(x_obj, adj_o_t, units[3], us[3])
        x_obj = (o_from_s + o_from_o) / 2
        x_pred = (p_from_s + p_from_o) / 2
        if (i + 1) % cfg.gcn_residual == 0:
            x_obj = x_obj + res_obj
            res_obj = x_obj
            x_pred = x_pred + res_pred
            res_pred = x_pred
    return x_obj, x_pred, state


def encode_graph(params, state, graph, cfg: ModelConfig):
    """fusion -> GCN on a SceneGraph of tensors.  Returns (x_obj, x_pred,
    state)."""
    x_obj, x_pred = fuse_features(params, graph.obj_dist, graph.obj_fmap,
                                  graph.pred_dist, cfg)
    return gcn_forward(params, state, x_obj, x_pred, graph.rel_ind, cfg)
