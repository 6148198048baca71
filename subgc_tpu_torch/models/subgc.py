"""Model orchestration: the teacher-forced training forward, and the test
path's encoder + sGPN + NMS -> decode-ready features.

The counterpart of ``subgc_tpu/models/subgc.py``: ``train_forward`` is the
reference's `_forward` (`AttModel.py:122-177`); the test side is the
encoder+sGPN+NMS prefix of its `_sample` (`AttModel.py:179-276`), the
Sub-GC branch batched over images, with NMS skipped under SCT, and the
Full-GC branch for one image.  The JAX package vmaps sGPN+NMS per image;
here the image axis is a batch dimension of every op.  The test entry
points run without autograd.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import EvalConfig, ModelConfig
from ..graph import SceneGraph, SubgraphSet
from ..utils.profiling import span
from . import decoder as D
from . import encoder as E
from . import gpn as G


class EncodedImage(NamedTuple):
    """Decode-ready features over a flat kept-sub-graph row axis."""
    feats: D.PreparedFeatures     # rows [B*Smax, ...]
    scores: torch.Tensor          # [B*Smax] sGPN scores of kept sub-graphs
    keep_ind: torch.Tensor        # [B*Smax] original sub-graph indices
    keep_valid: torch.Tensor      # [B*Smax] bool


def _full_graph_readout(params, read_out):
    """Full-GC read-out projection: two Linears, no activation
    (AttModel.py:100-102)."""
    ro = params["readout"]
    return (read_out @ ro["readout1"]["w"] + ro["readout1"]["b"]) \
        @ ro["readout2"]["w"] + ro["readout2"]["b"]


def _full_graph_mask(S, cfg: ModelConfig, device):
    """[S, obj_num] attention mask over every node but the dummy."""
    m = torch.zeros((S, cfg.obj_num), dtype=torch.float32, device=device)
    m[:, :cfg.obj_num - 1] = 1.0
    return m


def train_forward(params, state, graph: SceneGraph, labels, sub_obj_ind,
                  sub_att_mask, img_ix, cfg: ModelConfig, train: bool = True,
                  generator=None, ss_prob=None):
    """Teacher-forced forward (JAX ``subgc.py:36-90``).

    labels [S, T+2] (S = B * seq_per_img, image-major); sub_* [S, 2, half,
    N]; img_ix [S].  Sub-GC attends over each sentence's best-scoring
    positive sub-graph (sGPN BCE loss); Full-GC over every node of its
    image, with the detached mean read-out; ``share_att_train`` over the
    image's streams through node-set membership.  ``train`` selects batch
    statistics in BatchNorm and dropout drawn from ``generator``.

    Returns (logprobs [S, T+1, V+1], gpn_loss or None, scores, new_state):
    new_state holds the updated BatchNorm running statistics (``gcn_bn``,
    and ``att_bn`` under ``use_bn``).
    """
    x_obj, _, new_state = E.encode_graph(params, state, graph, cfg, train)
    chosen_ind = None
    if cfg.use_gpn:
        gpn_loss, scores, att_feats, fc_feats, att_masks, chosen_ind = \
            G.gpn_train_forward(params, x_obj, sub_obj_ind, sub_att_mask,
                                img_ix, cfg, train, generator)
    else:
        # Full-GC: the full graph per sentence (AttModel.py:140-149)
        gpn_loss, scores = None, None
        att_feats = x_obj[img_ix]                       # [S, N, L]
        fc_feats = _full_graph_readout(params, att_feats.mean(1).detach())
        att_masks = _full_graph_mask(att_feats.shape[0], cfg, x_obj.device)

    if cfg.share_att_train:
        mem = (G.node_membership(chosen_ind, att_masks, cfg.obj_num)
               if cfg.use_gpn else att_masks)
        feats = D.prepare_features_shared_train(params, fc_feats, x_obj, mem,
                                                cfg, train, generator)
        att_bn = state.get("att_bn")
    else:
        feats, att_bn = D.prepare_features_bn(params, fc_feats, att_feats,
                                              att_masks, cfg, train,
                                              generator, state.get("att_bn"))
    if cfg.use_bn:
        new_state = {**new_state, "att_bn": att_bn}
    logprobs = D.forward_teacher(params, feats, labels, cfg, train,
                                 generator, ss_prob)
    return logprobs, gpn_loss, scores, new_state


def _encode_one(params, x_obj, subs: SubgraphSet, cfg: ModelConfig,
                ecfg: EvalConfig, bn_state=None):
    """sGPN + NMS + feature prep: the JAX package's per-image ``_encode_one``
    with the image vmap written out as the leading axis of ``x_obj``
    [B, n_obj, L] and ``subs`` [B, S, ...].  Under SCT there is no NMS
    (AttModel.py:95): every slot of the bucket is a row and ``subs.valid``
    says which are real.  Returns (feats with rows [B, K, ...] and image
    streams [B, n_obj, *], scores, keep_ind, keep_valid), each [B, K]."""
    out = G.gpn_test_forward(params, x_obj, subs.obj_ind, subs.att_mask, cfg)
    if ecfg.sct:
        B, S = subs.valid.shape
        keep_ind = torch.arange(S, device=x_obj.device).expand(B, S)
        keep_valid = subs.valid
    else:
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
        out.att_masks[rows, keep_ind], cfg, bn_state=bn_state,
        image_shared=image_shared)
    return feats, out.scores[rows, keep_ind], keep_ind, keep_valid


@torch.no_grad()
def encode_images_batched(params, state, graph: SceneGraph,
                          subs: SubgraphSet, cfg: ModelConfig,
                          ecfg: EvalConfig) -> EncodedImage:
    """Batched-image Sub-GC encoder: graph [B, ...], subs [B, S, ...]
    (tensors).

    The kept sub-graphs of all images flatten into one [B*Smax] row axis
    that decodes in one beam search; the image-shared node streams stay per
    image, with ``img_ix = repeat(arange(B), Smax)``.  Full-GC has no
    batched route, as in the JAX package: it runs through
    :func:`encode_image`.
    """
    with span("subgc.encode"):
        x_obj, _, _ = E.encode_graph(params, state, graph, cfg)
        f, scores, keep_ind, keep_valid = _encode_one(
            params, x_obj, subs, cfg, ecfg, state.get("att_bn"))
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
                            keep_ind=flat(keep_ind),
                            keep_valid=flat(keep_valid))


@torch.no_grad()
def encode_image(params, state, graph: SceneGraph,
                 subs: Optional[SubgraphSet], cfg: ModelConfig,
                 ecfg: EvalConfig) -> EncodedImage:
    """Encoder + sGPN + (optional) NMS for ONE image: graph is a batch of 1,
    subs [S, ...] (tensors), or None for Full-GC.

    Full-GC (``use_gpn=False``, AttModel.py:196-206) decodes one pseudo
    sub-graph, the full graph: every node but the dummy, the mean read-out,
    score 1.  Otherwise rows are the image's kept sub-graphs."""
    if cfg.use_gpn:
        return encode_images_batched(params, state, graph,
                                     SubgraphSet(*(x[None] for x in subs)),
                                     cfg, ecfg)
    with span("subgc.encode"):
        x_obj, _, _ = E.encode_graph(params, state, graph, cfg)
        att_feats = x_obj[0:1]
        fc_feats = _full_graph_readout(params, att_feats.mean(1))
        dev = x_obj.device
        att_masks = _full_graph_mask(1, cfg, dev)
        feats, _ = D.prepare_features_bn(params, fc_feats, att_feats,
                                         att_masks, cfg,
                                         bn_state=state.get("att_bn"))
        return EncodedImage(
            feats=feats,
            scores=torch.ones((1,), dtype=torch.float32, device=dev),
            keep_ind=torch.zeros((1,), dtype=torch.int64, device=dev),
            keep_valid=torch.ones((1,), dtype=torch.bool, device=dev))
