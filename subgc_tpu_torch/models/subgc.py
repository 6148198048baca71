"""Sub-GC test path: encoder + sGPN + NMS -> decode-ready features.

The counterpart of the test side of ``subgc_tpu/models/subgc.py`` (the
encoder+sGPN+NMS prefix of the reference's `_sample`, `AttModel.py:179-276`),
Sub-GC branch only.  The JAX package vmaps sGPN+NMS per image; here the image
axis is a batch dimension of every op.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import EvalConfig, ModelConfig
from ..graph import SceneGraph, SubgraphSet
from . import decoder as D
from . import encoder as E
from . import gpn as G


class EncodedImage(NamedTuple):
    """Decode-ready features over a flat kept-sub-graph row axis."""
    feats: D.PreparedFeatures     # rows [B*Smax, ...]
    scores: torch.Tensor          # [B*Smax] sGPN scores of kept sub-graphs
    keep_ind: torch.Tensor        # [B*Smax] original sub-graph indices
    keep_valid: torch.Tensor      # [B*Smax] bool


def _check_supported(cfg: ModelConfig, ecfg: EvalConfig):
    if not cfg.use_gpn:
        raise NotImplementedError("Full-GC is not ported yet")
    if ecfg.sct:
        raise NotImplementedError("SCT decoding is not ported yet")


def _encode_one(params, x_obj, subs: SubgraphSet, cfg: ModelConfig,
                ecfg: EvalConfig):
    """sGPN + NMS + feature prep: the JAX package's per-image ``_encode_one``
    with the image vmap written out as the leading axis of ``x_obj``
    [B, n_obj, L] and ``subs`` [B, S, ...].  Returns (feats with rows
    [B, K, ...] and image streams [B, n_obj, *], scores, keep_ind,
    keep_valid), each [B, K]."""
    _check_supported(cfg, ecfg)
    out = G.gpn_test_forward(params, x_obj, subs.obj_ind, subs.att_mask, cfg)
    keep_ind, keep_valid = G.subgraph_nms(
        out.scores, subs.obj_ind, subs.att_mask, subs.valid, cfg,
        ecfg.gpn_nms_thres, ecfg.gpn_max_subg)
    rows = torch.arange(x_obj.shape[0], device=x_obj.device)[:, None]
    # the read-out projects only for the kept sub-graphs, and the node
    # features project once per image before any per-row gather
    image_shared = cfg.share_att_images and not ecfg.return_att
    fc_feats = G.readout_project(params, out.read_out[rows, keep_ind])
    feats = D.prepare_features_nodes(
        params, fc_feats, x_obj, subs.obj_ind[rows, keep_ind],
        out.att_masks[rows, keep_ind], cfg, image_shared=image_shared)
    return feats, out.scores[rows, keep_ind], keep_ind, keep_valid


def encode_images_batched(params, state, graph: SceneGraph,
                          subs: SubgraphSet, cfg: ModelConfig,
                          ecfg: EvalConfig) -> EncodedImage:
    """Batched-image encoder: graph [B, ...], subs [B, S, ...] (tensors).

    The kept sub-graphs of all images flatten into one [B*Smax] row axis
    that decodes in one beam search; the image-shared node streams stay per
    image, with ``img_ix = repeat(arange(B), Smax)``.
    """
    x_obj, _, _ = E.encode_graph(params, state, graph, cfg)
    f, scores, keep_ind, keep_valid = _encode_one(params, x_obj, subs, cfg,
                                                  ecfg)
    B, K = f.fc.shape[:2]

    def flat(x):
        return None if x is None else x.reshape((B * K,) + x.shape[2:])

    img_ix = None
    if f.att_img is not None:
        img_ix = torch.repeat_interleave(
            torch.arange(B, device=x_obj.device), K)
    feats = D.PreparedFeatures(
        fc=flat(f.fc), att=flat(f.att), p_att=flat(f.p_att),
        mask=flat(f.mask), fc_ih=flat(f.fc_ih),
        att_img=f.att_img, p_att_img=f.p_att_img, img_ix=img_ix)
    return EncodedImage(feats=feats, scores=flat(scores),
                        keep_ind=flat(keep_ind), keep_valid=flat(keep_valid))


def encode_image(params, state, graph: SceneGraph, subs: SubgraphSet,
                 cfg: ModelConfig, ecfg: EvalConfig) -> EncodedImage:
    """Encoder + sGPN + NMS for ONE image: graph is a batch of 1, subs
    [S, ...] (tensors).  Rows are that image's kept sub-graphs."""
    return encode_images_batched(params, state, graph,
                                 SubgraphSet(*(x[None] for x in subs)),
                                 cfg, ecfg)
