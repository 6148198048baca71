"""Seeded weights, made on the device in two large draws.

The layout is the one the port takes and the reference reads: nested dicts
(a list of layers for the GCN), Linear weights ``[in, out]`` with a bias
``b``, LSTM cells as ``w_ih [in, 4R]``, ``w_hh [R, 4R]``, ``b_ih``,
``b_hh``.  The distributions are PyTorch's defaults, as the paper's model
draws them: Linear weights and biases uniform in +-1/sqrt(fan_in) (the
sGPN's and the read-outs' biases zero), the GCN's units N(0, 0.001) with
zero biases, embedding tables N(0, 1), LSTM weights uniform in
+-1/sqrt(R), BatchNorm at scale 1, bias 0, running mean 0 and variance 1.
"""
from __future__ import annotations

import math

import torch


def _layout(cfg: dict):
    """[(path, shape, kind, scale)], kind: "u" uniform in +-scale, "n"
    normal times scale, "0" zeros, "1" ones."""
    L, E, R, H = (cfg["gcn_dim"], cfg["embed_dim"], cfg["rnn_size"],
                  cfg["att_hid_size"])
    V1 = cfg["vocab_size"] + 1
    out = []

    def linear(path, n_in, n_out, bias="u", init="u"):
        scale = 1e-3 if init == "n" else 1.0 / math.sqrt(n_in)
        out.append((path + ("w",), (n_in, n_out), init, scale))
        out.append((path + ("b",), (n_out,), bias, 1.0 / math.sqrt(n_in)))

    linear(("fusion", "obj_v_proj"), cfg["att_feat_size"], L)
    if cfg["noun_fuse"]:
        out.append((("fusion", "obj_emb"), (cfg["num_obj_classes"], E),
                    "n", 1.0))
        linear(("fusion", "obj_emb_proj"), E, L)
    out.append((("fusion", "pred_emb"), (cfg["num_rel_classes"], E), "n",
                1.0))
    linear(("fusion", "pred_emb_proj"), E, L)
    for i in range(cfg["gcn_layers"]):
        for u in range(4):
            linear(("gcn", i, u, "lft"), L, 512, "0", "n")
            linear(("gcn", i, u, "rgt"), 512, L, "0", "n")
            if cfg["gcn_bn"]:
                out.append((("gcn", i, u, "bn", "scale"), (L,), "1", 1.0))
                out.append((("gcn", i, u, "bn", "bias"), (L,), "0", 1.0))
    if cfg["use_gpn"]:
        G = cfg["gpn_hid_dim"]
        linear(("gpn", "fc1"), 2 * L, G, "0")
        linear(("gpn", "fc2"), G, 1, "0")
        linear(("gpn", "readout1"), 2 * L, G, "0")
        linear(("gpn", "readout2"), G, 2 * L, "0")
    else:
        linear(("readout", "readout1"), L, H, "0")
        linear(("readout", "readout2"), H, 2 * L, "0")
    d = ("decoder",)
    out.append((d + ("embed",), (V1, cfg["input_encoding_size"]), "n", 1.0))
    linear(d + ("fc_embed1",), 2 * L, cfg["fc_feat_size"])
    linear(d + ("fc_embed2",), cfg["fc_feat_size"], R)
    linear(d + ("att_embed",), L, R)
    linear(d + ("ctx2att",), R, H)
    for name, n_in in (("att_lstm", cfg["input_encoding_size"] + 2 * R),
                       ("lang_lstm", 2 * R)):
        s = 1.0 / math.sqrt(R)
        out += [(d + (name, "w_ih"), (n_in, 4 * R), "u", s),
                (d + (name, "w_hh"), (R, 4 * R), "u", s),
                (d + (name, "b_ih"), (4 * R,), "u", s),
                (d + (name, "b_hh"), (4 * R,), "u", s)]
    linear(d + ("h2att",), R, H)
    linear(d + ("alpha_net",), H, 1)
    linear(d + ("logit",), R, V1)
    return out


def make(cfg: dict, seed: int, device):
    """(params, state): the weights as float32 tensors on ``device``, each
    leaf with storage of its own, drawn from a generator on the device
    seeded with ``seed``; the same seed gives the same weights."""
    layout = _layout(cfg)
    n_u = sum(math.prod(s) for _, s, k, _ in layout if k == "u")
    n_n = sum(math.prod(s) for _, s, k, _ in layout if k == "n")
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    uni = torch.rand(n_u, generator=gen, device=device).mul_(2).sub_(1)
    nor = torch.randn(n_n, generator=gen, device=device)
    params = {}
    at = {"u": 0, "n": 0}
    for path, shape, kind, scale in layout:
        size = math.prod(shape)
        if kind in at:
            src = uni if kind == "u" else nor
            t = src[at[kind]:at[kind] + size].view(shape) * scale
            at[kind] += size
        else:
            t = torch.full(shape, float(kind), device=device)
        node = params
        for key, nxt in zip(path[:-1], path[1:]):
            # a list of GCN layers (and of units) where the next key is an
            # index, a dict elsewhere
            if isinstance(node, list) and len(node) == key:
                node.append([] if isinstance(nxt, int) else {})
            elif isinstance(node, dict) and key not in node:
                node[key] = [] if isinstance(nxt, int) else {}
            node = node[key]
        node[path[-1]] = t
    L = cfg["gcn_dim"]

    def bn_state():
        return ({"mean": torch.zeros(L, device=device),
                 "var": torch.ones(L, device=device)}
                if cfg["gcn_bn"] else {})

    state = {"gcn_bn": [[bn_state() for _ in range(4)]
                        for _ in range(cfg["gcn_layers"])]}
    return params, state


def clone(tree):
    """A copy of a weights tree with storage of its own."""
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone(v) for v in tree]
    return tree.clone()
