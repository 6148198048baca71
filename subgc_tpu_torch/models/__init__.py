"""Model factory (the reference's `models.setup(opt)`, models/__init__.py:43-59);
the port's counterpart of ``subgc_tpu/models/__init__.py``.

``setup`` builds the parameter tree for a config, with GloVe class
embeddings when the data paths provide them, and optionally restores it
from a checkpoint directory of either package (optimistic, vocab-remapped
transfer).  ``setup_numpy`` is its host core, which ``cli/train.py`` calls
too.  The fresh weights are ``init_params_numpy(mcfg, seed)``'s, not the
JAX package's ``PRNGKey(2019)`` draws; from a shared ``start_from`` the two
packages' ``setup`` agree exactly wherever the checkpoint supplies a leaf.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


def setup_numpy(mcfg, dcfg=None, seed: int = 2019,
                start_from: Optional[str] = None,
                word_mapping: Optional[np.ndarray] = None,
                optim: Optional[str] = None):
    """Returns ``(params, state, loaded)`` as numpy trees.

    Class counts come from ``dcfg.obj_name_path`` / ``rel_name_path`` when
    that file exists, else from ``mcfg.num_obj_classes`` /
    ``num_rel_classes``; GloVe rows only when ``dcfg.glove_path`` exists.
    Under ``start_from`` the checkpoint's params go through
    ``optimistic_restore`` (with ``word_mapping``) and its state replaces
    the fresh one; ``loaded`` is then its ``(opt_state, infos,
    histories)`` as ``train.checkpoint.load_checkpoint`` reads them (an
    ``opt_state`` only when ``optim`` names the optimizer to resume), else
    None."""
    from ..io.glove import class_embeddings
    from ..train import checkpoint as C
    from .params import init_params_numpy

    obj_vecs = rel_vecs = None
    n_obj, n_rel = mcfg.num_obj_classes, mcfg.num_rel_classes
    if dcfg is not None and os.path.exists(dcfg.obj_name_path):
        obj_names = np.load(dcfg.obj_name_path, allow_pickle=True,
                            encoding="latin1")
        rel_names = np.load(dcfg.rel_name_path, allow_pickle=True,
                            encoding="latin1")
        n_obj, n_rel = len(obj_names), len(rel_names)
        if os.path.exists(dcfg.glove_path):
            obj_vecs = class_embeddings(list(obj_names), dcfg.glove_path,
                                        mcfg.embed_dim)
            rel_vecs = class_embeddings(list(rel_names), dcfg.glove_path,
                                        mcfg.embed_dim)
    params, state = init_params_numpy(mcfg, seed=seed, n_obj_names=n_obj,
                                      n_pred_names=n_rel, obj_glove=obj_vecs,
                                      pred_glove=rel_vecs)
    if not start_from:
        return params, state, None
    p2, s2, opt_state, infos, histories = C.load_checkpoint(
        start_from, params_template=params if optim else None,
        optim=optim or "adam")
    params = C.optimistic_restore(params, p2, word_mapping=word_mapping)
    return params, s2, (opt_state, infos, histories)


def setup(mcfg, dcfg=None, seed: int = 2019,
          start_from: Optional[str] = None,
          word_mapping: Optional[np.ndarray] = None, device="cuda"):
    """Returns ``(params, state)`` as tensors on ``device`` (the card unless
    the caller asks for the CPU); see :func:`setup_numpy`."""
    from ..device import resolve_device
    from .params import params_from_numpy
    dev = resolve_device(device)
    params, state, _ = setup_numpy(mcfg, dcfg, seed, start_from,
                                   word_mapping)
    return params_from_numpy(params, dev), params_from_numpy(state, dev)
