"""Parameter trees: carried over from the JAX package, drawn anew, or loaded.

Parameters are a nested dict (lists for the GCN layers) of float32 tensors
with the same keys as the JAX pytree (``subgc_tpu/models/params.py``):

* Linear weights are stored ``[in, out]`` and applied as ``x @ w + b`` (the
  transpose of torch's ``nn.Linear`` layout).
* LSTM cells keep PyTorch's stacked (i, f, g, o) gate order in ``w_ih``
  ``[in, 4R]``, ``w_hh`` ``[R, 4R]``, ``b_ih``, ``b_hh``.

So a JAX checkpoint's arrays go through :func:`params_from_numpy` unchanged,
and :func:`params_to_numpy` + :func:`save_model_npz` write a ``model.npz``
that the JAX package's ``load_checkpoint`` reads.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..device import resolve_device

_SEP = "///"


def params_from_numpy(tree, device="cuda", requires_grad: bool = False):
    """Nested dict/list/tuple of arrays -> the same structure of tensors on
    ``device``, each with storage of its own (an optimizer may update them
    in place).  Floating arrays become float32, integer arrays int64.
    ``requires_grad`` makes every floating tensor a leaf that requires grad
    (the trainable params; never the model state)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        a = np.asarray(x)
        floating = np.issubdtype(a.dtype, np.floating)
        if floating:
            a = a.astype(np.float32)
        elif np.issubdtype(a.dtype, np.integer):
            a = a.astype(np.int64)
        t = torch.from_numpy(np.array(a, order="C", copy=True)).to(dev)
        return t.requires_grad_() if requires_grad and floating else t

    return conv(tree)


def params_to_numpy(tree):
    """The inverse of :func:`params_from_numpy`: the same structure of
    numpy arrays on the host (detached)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


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


def _bn(dim):
    return {"scale": np.ones((dim,), np.float32),
            "bias": np.zeros((dim,), np.float32)}


def _bn_state(dim):
    return {"mean": np.zeros((dim,), np.float32),
            "var": np.ones((dim,), np.float32)}


def _lstm_cell(rng, n_in, n_hid):
    bound = 1.0 / math.sqrt(n_hid)

    def u(shape):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    return {"w_ih": u((n_in, 4 * n_hid)), "w_hh": u((n_hid, 4 * n_hid)),
            "b_ih": u((4 * n_hid,)), "b_hh": u((4 * n_hid,))}


def init_params_numpy(cfg: ModelConfig, seed: int = 0,
                      n_obj_names: Optional[int] = None,
                      n_pred_names: Optional[int] = None,
                      obj_glove: Optional[np.ndarray] = None,
                      pred_glove: Optional[np.ndarray] = None):
    """(params, state) as numpy arrays, with the shapes and distributions of
    the JAX package's ``init_params`` (torch ``nn.Linear`` defaults, N(0,
    0.001) GCN units with zero biases, zero-bias sGPN layers, N(0, 1)
    embeddings, or the GloVe tables ``obj_glove`` / ``pred_glove`` of
    ``io/glove.py::class_embeddings`` for the class embeddings), drawn from
    ``np.random.default_rng(seed)``.

    BatchNorm layers (``gcn_bn``: ``bn`` per GCN unit; ``use_bn`` 1/2:
    ``att_bn0``/``att_bn1`` in the decoder) start at scale 1, bias 0, and
    their running statistics (``state["gcn_bn"][layer][unit]``,
    ``state["att_bn"]``) at mean 0, var 1, as the JAX package's do."""
    rng = np.random.default_rng(seed)
    n_obj_names = n_obj_names or cfg.num_obj_classes
    n_pred_names = n_pred_names or cfg.num_rel_classes
    L, E, R, H = cfg.gcn_dim, cfg.embed_dim, cfg.rnn_size, cfg.att_hid_size
    V1 = cfg.vocab_size + 1

    def normal(shape):
        return rng.standard_normal(shape).astype(np.float32)

    def table(glove, n):
        if glove is not None:
            return np.asarray(glove, np.float32)
        return normal((n, E))

    fusion = {"obj_v_proj": _linear(rng, cfg.att_feat_size, L)}
    if cfg.noun_fuse:
        fusion["obj_emb"] = table(obj_glove, n_obj_names)
        fusion["obj_emb_proj"] = _linear(rng, E, L)
    fusion["pred_emb"] = table(pred_glove, n_pred_names)
    fusion["pred_emb_proj"] = _linear(rng, E, L)
    params = {"fusion": fusion}

    def unit():
        u = {"lft": _linear(rng, L, 512, "gcn", "zero"),
             "rgt": _linear(rng, 512, L, "gcn", "zero")}
        if cfg.gcn_bn:
            u["bn"] = _bn(L)
        return u

    params["gcn"] = [[unit() for _ in range(4)]
                     for _ in range(cfg.gcn_layers)]
    state = {"gcn_bn": [[_bn_state(L) if cfg.gcn_bn else {}
                         for _ in range(4)] for _ in range(cfg.gcn_layers)]}

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
    if cfg.use_bn:
        # BN0 over the true input dim gcn_dim (see the JAX package's note)
        params["decoder"]["att_bn0"] = _bn(L)
        state["att_bn"] = {"bn0": _bn_state(L)}
        if cfg.use_bn == 2:
            params["decoder"]["att_bn1"] = _bn(R)
            state["att_bn"]["bn1"] = _bn_state(R)
    return params, state


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                n_obj_names: Optional[int] = None,
                n_pred_names: Optional[int] = None,
                requires_grad: bool = False):
    """(params, state) as tensors on ``device``; see
    :func:`init_params_numpy`.  ``requires_grad`` makes the params (not the
    state) leaves that require grad, for training.  A state from elsewhere
    (a JAX checkpoint's ``"state"``, the JAX package's ``init_params``)
    goes onto the device the same way, through :func:`params_from_numpy`."""
    dev = resolve_device(device)
    params, state = init_params_numpy(cfg, seed, n_obj_names, n_pred_names)
    return (params_from_numpy(params, dev, requires_grad),
            params_from_numpy(state, dev))


def _flatten(tree, prefix=""):
    """Nested dict/list/tuple -> {path key: array}, the ``model.npz`` format
    of the JAX package's ``train/checkpoint.py`` (``///``-joined keys; list
    and tuple lengths under ``__len__``, ``{}`` as ``__empty__``, None as
    ``__none__``)."""
    def key(k):
        return f"{prefix}{_SEP}{k}" if prefix else str(k)

    out = {}
    if isinstance(tree, dict):
        if not tree:
            return {key("__empty__"): np.asarray(0)}
        for k, v in tree.items():
            out.update(_flatten(v, key(k)))
    elif isinstance(tree, (list, tuple)):
        out[key("__len__")] = np.asarray([len(tree),
                                          int(isinstance(tree, tuple))])
        for i, v in enumerate(tree):
            out.update(_flatten(v, key(i)))
    elif tree is None:
        out[key("__none__")] = np.asarray(0)
    else:
        out[prefix] = np.asarray(tree)
    return out


def _unflatten(flat):
    """Rebuild the nested structure of a ``model.npz`` from its path keys
    (the inverse of :func:`_flatten`)."""
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


def save_model_npz(path: str, tree) -> None:
    """Write a nested tree of arrays or tensors as ``model.npz`` (for a
    training checkpoint: ``{"params": ..., "state": ...}``)."""
    np.savez(path, **_flatten(params_to_numpy(tree)))


def load_model_npz(path: str):
    """Read a ``model.npz`` checkpoint into its nested numpy tree (for a
    training checkpoint: ``{"params": ..., "state": ...}``)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(flat)
