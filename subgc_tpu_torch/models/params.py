"""Parameter trees: carried over from the JAX package, drawn anew, or loaded.

Parameters are a nested dict (lists for the GCN layers) of float32 tensors
with the same keys as the JAX pytree (``subgc_tpu/models/params.py``):

* Linear weights are stored ``[in, out]`` and applied as ``x @ w + b`` (the
  transpose of torch's ``nn.Linear`` layout).
* LSTM cells keep PyTorch's stacked (i, f, g, o) gate order in ``w_ih``
  ``[in, 4R]``, ``w_hh`` ``[R, 4R]``, ``b_ih``, ``b_hh``.

So a JAX checkpoint's arrays go through :func:`params_from_numpy` unchanged.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..device import resolve_device

_SEP = "///"


def params_from_numpy(tree, device="cuda"):
    """Nested dict/list/tuple of arrays -> the same structure of tensors on
    ``device``.  Floating arrays become float32, integer arrays int64."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        a = np.asarray(x)
        if np.issubdtype(a.dtype, np.floating):
            a = a.astype(np.float32, copy=False)
        elif np.issubdtype(a.dtype, np.integer):
            a = a.astype(np.int64, copy=False)
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return conv(tree)


def _linear(rng, n_in, n_out, init="torch", bias="default"):
    if init == "torch":
        bound = 1.0 / math.sqrt(n_in)
        w = rng.uniform(-bound, bound, (n_in, n_out))
    elif init == "gcn":
        w = 0.001 * rng.standard_normal((n_in, n_out))
    else:
        raise ValueError(init)
    if bias == "default" and init == "torch":
        bound = 1.0 / math.sqrt(n_in)
        b = rng.uniform(-bound, bound, (n_out,))
    else:
        b = np.zeros((n_out,))
    return {"w": w.astype(np.float32), "b": b.astype(np.float32)}


def _zero_bias(p):
    return {"w": p["w"], "b": np.zeros_like(p["b"])}


def _lstm_cell(rng, n_in, n_hid):
    bound = 1.0 / math.sqrt(n_hid)

    def u(shape):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    return {"w_ih": u((n_in, 4 * n_hid)), "w_hh": u((n_hid, 4 * n_hid)),
            "b_ih": u((4 * n_hid,)), "b_hh": u((4 * n_hid,))}


def init_params_numpy(cfg: ModelConfig, seed: int = 0,
                      n_obj_names: Optional[int] = None,
                      n_pred_names: Optional[int] = None):
    """(params, state) as numpy arrays, with the shapes and distributions of
    the JAX package's ``init_params`` (torch ``nn.Linear`` defaults, N(0,
    0.001) GCN units with zero biases, zero-bias sGPN layers, N(0, 1)
    embeddings), drawn from ``np.random.default_rng(seed)``.

    Sub-GC and Full-GC layouts without BatchNorm; ``gcn_bn`` and ``use_bn``
    raise, as the port does not run them yet."""
    if cfg.gcn_bn or cfg.use_bn:
        raise NotImplementedError("BatchNorm layers are not ported yet")
    rng = np.random.default_rng(seed)
    n_obj_names = n_obj_names or cfg.num_obj_classes
    n_pred_names = n_pred_names or cfg.num_rel_classes
    L, E, R, H = cfg.gcn_dim, cfg.embed_dim, cfg.rnn_size, cfg.att_hid_size
    V1 = cfg.vocab_size + 1

    def normal(shape):
        return rng.standard_normal(shape).astype(np.float32)

    fusion = {"obj_v_proj": _linear(rng, cfg.att_feat_size, L)}
    if cfg.noun_fuse:
        fusion["obj_emb"] = normal((n_obj_names, E))
        fusion["obj_emb_proj"] = _linear(rng, E, L)
    fusion["pred_emb"] = normal((n_pred_names, E))
    fusion["pred_emb_proj"] = _linear(rng, E, L)
    params = {"fusion": fusion}

    params["gcn"] = [[{"lft": _linear(rng, L, 512, "gcn", "zero"),
                       "rgt": _linear(rng, 512, L, "gcn", "zero")}
                      for _ in range(4)] for _ in range(cfg.gcn_layers)]
    state = {"gcn_bn": [[{} for _ in range(4)]
                        for _ in range(cfg.gcn_layers)]}

    if cfg.use_gpn:
        gpn = {}
        if not cfg.use_gt_subg:
            gpn["fc1"] = _zero_bias(_linear(rng, 2 * L, cfg.gpn_hid_dim))
            gpn["fc2"] = _zero_bias(_linear(rng, cfg.gpn_hid_dim, 1))
        gpn["readout1"] = _zero_bias(_linear(rng, 2 * L, cfg.gpn_hid_dim))
        gpn["readout2"] = _zero_bias(_linear(rng, cfg.gpn_hid_dim, 2 * L))
        params["gpn"] = gpn
    else:
        params["readout"] = {"readout1": _zero_bias(_linear(rng, L, H)),
                             "readout2": _zero_bias(_linear(rng, H, 2 * L))}

    params["decoder"] = {
        "embed": normal((V1, cfg.input_encoding_size)),
        "fc_embed1": _linear(rng, 2 * L, cfg.fc_feat_size),
        "fc_embed2": _linear(rng, cfg.fc_feat_size, R),
        "att_embed": _linear(rng, L, R),
        "ctx2att": _linear(rng, R, H),
        "att_lstm": _lstm_cell(rng, cfg.input_encoding_size + 2 * R, R),
        "lang_lstm": _lstm_cell(rng, 2 * R, R),
        "h2att": _linear(rng, R, H),
        "alpha_net": _linear(rng, H, 1),
        "logit": _linear(rng, R, V1),
    }
    return params, state


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                n_obj_names: Optional[int] = None,
                n_pred_names: Optional[int] = None):
    """(params, state) as tensors on ``device``; see
    :func:`init_params_numpy`."""
    dev = resolve_device(device)
    params, state = init_params_numpy(cfg, seed, n_obj_names, n_pred_names)
    return params_from_numpy(params, dev), state


def _unflatten(flat):
    """Rebuild the nested structure of a ``model.npz`` from its path keys
    (the JAX package's ``train/checkpoint.py`` format)."""
    if list(flat.keys()) == [""]:
        return flat[""]
    root = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def _rebuild(node):
        if not isinstance(node, dict):
            return node
        if "__none__" in node and len(node) == 1:
            return None
        if "__empty__" in node and len(node) == 1:
            return {}
        if "__len__" in node:
            n, is_tuple = (int(x) for x in node["__len__"])
            items = [_rebuild(node[str(i)]) for i in range(n)]
            return tuple(items) if is_tuple else items
        return {k: _rebuild(v) for k, v in node.items()}

    return _rebuild(root)


def load_model_npz(path: str):
    """Read a ``model.npz`` checkpoint into its nested numpy tree (for a
    training checkpoint: ``{"params": ..., "state": ...}``)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(flat)
