"""Scene-graph encoder: feature fusion + GCN backbone (Sub-GC variant).

The counterpart of ``subgc_tpu/models/encoder.py``: the node/relation
adjacency is one one-hot comparison instead of the reference's per-image
scatter loop (`models/lib/gcn_backbone.py:55-67`), and message passing is
two matmuls per collection unit (`graph_conv_unit.py:28-36`), with the
Full-GC variant's BatchNorm between them and the adjacency product: running
statistics at eval, batch statistics in training (which also return the
updated running statistics).  Under ``compute_dtype="bfloat16"`` the GCN's
products run in bf16 as the JAX package's do; the feature fusion stays
float32 there too.
"""
from __future__ import annotations

import torch

from ..config import ModelConfig
from ..parallel import distributed as DP


def batch_norm_1d(x, p, s, eps: float = 1e-5):
    """torch.nn.BatchNorm1d at eval over the last axis: running statistics
    ``s`` {mean, var}, affine ``p`` {scale, bias}.  Written in the JAX
    package's order, ``(x - mean) * rsqrt(var + eps) * scale + bias``, which
    ``F.batch_norm`` does not keep."""
    return (x - s["mean"]) * torch.rsqrt(s["var"] + eps) * p["scale"] \
        + p["bias"]


def batch_norm_1d_train(x, p, s, momentum: float = 0.1, eps: float = 1e-5,
                        mask=None):
    """torch.nn.BatchNorm1d in training over a flattened ``[M, C]`` view:
    batch statistics, written in the JAX package's order
    (``subgc_tpu/models/encoder.py:26-56``).  Returns (y, new_state).

    The batch variance is the biased one (``jnp.var``); the running update
    takes the unbiased one, ``var * m / (m - 1)``, as torch's does.  The new
    running statistics carry no gradient.

    mask [M] (optional): statistics cover only rows with mask 1, divided by
    ``mask.sum()`` (the reference's pack_wrapper, `AttModel.py:28-37,364`,
    where BatchNorm1d sees only the packed real rows).

    Under ``parallel.distributed.data_parallel(group)`` the count, the mean
    and the variance are the global batch's, as JAX's sharded step computes
    them, in the same two passes (the global mean, then the global sum of
    squared deviations), through the differentiable all-reduce, so that
    the moments' gradient reaches every rank (SyncBatchNorm's pattern).
    """
    group = DP.active_group()
    if group is not None:
        if mask is None:
            mask = torch.ones(x.shape[:1], dtype=x.dtype, device=x.device)
        m = DP.all_reduce_sum(mask.sum(), group)
        mean = DP.all_reduce_sum((x * mask[:, None]).sum(0), group) / m
        d = (x - mean) * mask[:, None]
        var = DP.all_reduce_sum((d * d).sum(0), group) / m
        unbiased = var * (m / torch.clamp(m - 1.0, min=1.0))
    elif mask is None:
        m = x.shape[0]
        mean = x.mean(0)
        d = x - mean
        var = (d * d).mean(0)
        unbiased = var * (m / max(m - 1, 1))
    else:
        m = mask.sum()
        mean = (x * mask[:, None]).sum(0) / m
        d = (x - mean) * mask[:, None]
        var = (d * d).sum(0) / m
        unbiased = var * (m / torch.clamp(m - 1.0, min=1.0))
    new_state = {
        "mean": ((1 - momentum) * s["mean"] + momentum * mean).detach(),
        "var": ((1 - momentum) * s["var"] + momentum * unbiased).detach()}
    y = (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y, new_state


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


def _collect(source, adj, unit, ustate, cfg: ModelConfig,
             train: bool = False):
    """One collection unit: low-rank transform of source, BatchNorm if the
    unit has one, adjacency average (graph_conv_unit.py:28-36).  adj is
    [B,T,S], source [B,S,L].  Returns (features, the unit's new BatchNorm
    state).

    In bf16 (JAX ``encoder.py:102-119``): both Linears in bf16, bias added
    in bf16; back to float32 before BatchNorm; the adjacency product of the
    bf16 operands summed in float32; the degree division in float32."""
    dt = cfg.cdtype
    if dt == torch.float32:
        h = _dense(_dense(source, unit["lft"]), unit["rgt"])
    else:
        def dense(x, p):
            return x @ p["w"].to(dt) + p["b"].to(dt)
        h = dense(dense(source.to(dt), unit["lft"]), unit["rgt"]).float()
    if "bn" in unit:
        if train:
            b, s_, l_ = h.shape
            y, ustate = batch_norm_1d_train(h.reshape(-1, l_), unit["bn"],
                                            ustate)
            h = y.reshape(b, s_, l_)
        else:
            h = batch_norm_1d(h, unit["bn"], ustate)
    if dt != torch.float32:
        h = h.to(dt).float()            # adj is 0/1: exact in bf16
    collect = adj @ h
    degree = adj.sum(2)[..., None]
    return torch.relu(collect / (degree + 1e-7)), ustate


def gcn_forward(params, state, x_obj, x_pred, rel_ind, cfg: ModelConfig,
                train: bool = False):
    """Stacked graph convolutions with periodic residuals
    (gcn_backbone.py:29-53).  BatchNorm units read their running statistics
    from ``state["gcn_bn"][layer][unit]`` at eval; in training they use
    batch statistics and the returned state holds the updated running
    statistics.

    Returns (x_obj [B,N,L], x_pred [B,K,L], new state).
    """
    if cfg.gcn_layers == 0:
        return x_obj, x_pred, state

    adj_s, adj_o = make_adjacency(rel_ind, x_obj.shape[1])
    adj_s_t = adj_s.transpose(1, 2)
    adj_o_t = adj_o.transpose(1, 2)

    res_obj, res_pred = x_obj, x_pred
    new_bn = []
    for i, units in enumerate(params["gcn"]):
        us = state["gcn_bn"][i]
        # both node and edge updates read the *input* features of this layer
        o_from_s, us0 = _collect(x_pred, adj_s, units[0], us[0], cfg, train)
        o_from_o, us1 = _collect(x_pred, adj_o, units[1], us[1], cfg, train)
        p_from_s, us2 = _collect(x_obj, adj_s_t, units[2], us[2], cfg,
                                 train)
        p_from_o, us3 = _collect(x_obj, adj_o_t, units[3], us[3], cfg,
                                 train)
        x_obj = (o_from_s + o_from_o) / 2
        x_pred = (p_from_s + p_from_o) / 2
        new_bn.append([us0, us1, us2, us3])
        if (i + 1) % cfg.gcn_residual == 0:
            x_obj = x_obj + res_obj
            res_obj = x_obj
            x_pred = x_pred + res_pred
            res_pred = x_pred
    return x_obj, x_pred, {**state, "gcn_bn": new_bn}


def encode_graph(params, state, graph, cfg: ModelConfig, train: bool = False):
    """fusion -> GCN on a SceneGraph of tensors.  Returns (x_obj, x_pred,
    new state)."""
    x_obj, x_pred = fuse_features(params, graph.obj_dist, graph.obj_fmap,
                                  graph.pred_dist, cfg)
    return gcn_forward(params, state, x_obj, x_pred, graph.rel_ind, cfg,
                       train)
