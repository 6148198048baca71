"""Checkpoint / resume (reference train.py:36-52,194-227); the counterpart
of ``subgc_tpu/train/checkpoint.py``.

One checkpoint directory holds:

* ``model.npz``      — ``{"params", "state"}`` in the JAX package's
  ``///`` path format (``models/params.py::save_model_npz``), so that either
  package reads what the other writes;
* ``optimizer.npz``  — the port's optimizer state under named keys: its
  ``kind`` (``adam``, ``adamw``, ``sgd``, ``rmsprop`` or ``adagrad``),
  ``count`` and each named moment as ``<moment>///<param path>`` (Adam's
  ``mu`` / ``nu``, sgd's ``trace``, rmsprop's ``nu``, adagrad's
  ``sum_of_squares``); a file without ``kind`` is an Adam file of an
  earlier version of the port;
* ``infos.json``     — iteration/epoch counters, configs, vocab;
* ``histories.json`` — loss/lr/ss-prob/val histories.

An ``optimizer.npz`` whose keys or shapes do not match the current params
(a JAX checkpoint's optax leaves, say) is not loaded: the moments start
afresh with a warning, as the JAX package does on a layout change.  One
written by another optimizer than the one resuming raises.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..models.params import (_flatten, _unflatten, load_model_npz,
                             params_to_numpy, save_model_npz)
from .optim import MOMENTS, OptState


def save_checkpoint(ckpt_dir: str, params, state, opt_state, infos: dict,
                    histories: dict, suffix: str = "") -> None:
    """Write a full training checkpoint (reference train.py:36-52);
    ``opt_state`` is an ``optim.OptState`` or None."""
    os.makedirs(ckpt_dir, exist_ok=True)
    save_model_npz(os.path.join(ckpt_dir, f"model{suffix}.npz"),
                   {"params": params, "state": state})
    if opt_state is not None:
        flat = _flatten({k: params_to_numpy(v)
                         for k, v in opt_state.moments.items()})
        np.savez(os.path.join(ckpt_dir, f"optimizer{suffix}.npz"),
                 kind=np.asarray(opt_state.kind),
                 count=np.asarray(opt_state.count), **flat)
    with open(os.path.join(ckpt_dir, f"infos{suffix}.json"), "w") as f:
        json.dump(infos, f)
    with open(os.path.join(ckpt_dir, f"histories{suffix}.json"), "w") as f:
        json.dump(histories, f)


def _load_opt_state(path: str, params_np, optim: str):
    """The port's ``optimizer.npz`` as an ``OptState`` of numpy trees, or
    None with a warning when its layout does not match ``params_np``.
    Raises when it was written by another optimizer than ``optim``."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    count = flat.pop("count", None)
    kind = str(flat.pop("kind", "adam"))
    if kind != optim:
        raise ValueError(f"{path} holds {kind!r} optimizer state; resuming "
                         f"under optim={optim!r} would start its moments "
                         f"from another optimizer's (pass the same "
                         f"--optim, or start without the checkpoint's "
                         f"optimizer.npz)")
    want = _flatten({k: params_np for k in MOMENTS[kind]})
    if count is None or sorted(flat) != sorted(want) or any(
            np.shape(flat[k]) != np.shape(want[k]) for k in want):
        print(f"warning: optimizer state in {path} does not match the "
              f"current optimizer layout; reinitializing moments")
        return None
    return OptState(kind=kind, count=int(count), moments=_unflatten(flat))


def load_checkpoint(ckpt_dir: str, suffix: str = "", params_template=None,
                    optim: str = "adam"):
    """Returns (params, state, opt_state, infos, histories) as numpy trees
    and dicts.  ``opt_state`` is an ``optim.OptState`` of numpy moments
    when ``params_template`` (the params to be trained, numpy) is given and
    ``optimizer.npz`` matches it, else None; an ``optimizer.npz`` of
    another optimizer than ``optim`` raises."""
    blob = load_model_npz(os.path.join(ckpt_dir, f"model{suffix}.npz"))
    opt_state = None
    opt_path = os.path.join(ckpt_dir, f"optimizer{suffix}.npz")
    if params_template is not None and os.path.exists(opt_path):
        opt_state = _load_opt_state(opt_path, params_template, optim)
    infos, histories = {}, {}
    ip = os.path.join(ckpt_dir, f"infos{suffix}.json")
    hp = os.path.join(ckpt_dir, f"histories{suffix}.json")
    if os.path.exists(ip):
        with open(ip) as f:
            infos = json.load(f)
    if os.path.exists(hp):
        with open(hp) as f:
            histories = json.load(f)
    return blob["params"], blob["state"], opt_state, infos, histories


def optimistic_restore(params, loaded, word_mapping=None, verbose=True):
    """Shape-tolerant restore + vocab-remap finetune (models/__init__.py:14-41,
    misc/utils.py:202-221), on numpy trees.

    A leaf whose shape matches takes the loaded value; one that does not
    keeps the current value, except the token embedding and logit rows,
    which ``word_mapping`` (new vocab index -> old index, or -1) copies
    from the loaded rows, as the reference's ``word_mapping.npy``
    COCO->Flickr transfer does.
    """
    def merge(path, cur, new):
        if new is None:
            return cur
        if np.shape(cur) == np.shape(new):
            return np.asarray(new)
        if verbose:
            print(f"shape mismatch at {path}: have {np.shape(cur)}, "
                  f"ckpt {np.shape(new)}")
        if word_mapping is not None and path in (
                ("decoder", "embed"), ("decoder", "logit", "w"),
                ("decoder", "logit", "b")):
            new = np.asarray(new)
            cur = np.array(cur)
            wm = np.asarray(word_mapping)
            ok = wm >= 0
            if path == ("decoder", "logit", "w"):
                cur[:, ok] = new[:, wm[ok]]
            else:
                cur[ok] = new[wm[ok]]
            return cur
        return cur

    def walk(path, cur, new):
        if isinstance(cur, dict):
            return {k: walk(path + (k,), cur[k],
                            new.get(k) if isinstance(new, dict) else None)
                    for k in cur}
        if isinstance(cur, (list, tuple)):
            newlist = new if isinstance(new, (list, tuple)) \
                else [None] * len(cur)
            return type(cur)(walk(path + (i,), c, n) for i, (c, n) in
                             enumerate(zip(cur, newlist)))
        return merge(path, cur, new)

    return walk((), params, loaded)
