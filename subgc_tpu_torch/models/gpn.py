"""Sub-graph proposal network (sGPN) test path + sub-graph NMS.

The counterpart of ``subgc_tpu/models/gpn.py`` (reference
`models/lib/gpn.py`).  Every function takes optional leading image axes, so
the per-image ``vmap`` of the JAX package is a batch dimension here: NMS runs
for a whole image batch at once, and its parallel fixpoint iterates until
every image in the batch has converged.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import ModelConfig
from .encoder import one_hot


def _dense(x, p):
    return x @ p["w"] + p["b"]


def gpn_score(params, read_out):
    """MLP + sigmoid sub-graph score at eval (gpn.py:50-55)."""
    g = params["gpn"]
    h = torch.relu(_dense(read_out, g["fc1"]))
    return torch.sigmoid(_dense(h, g["fc2"])[..., 0])


def readout_project(params, read_out):
    """read_out_proj: 2L -> hid -> 2L, two Linears, no activation
    (gpn.py:35-38)."""
    g = params["gpn"]
    return _dense(_dense(read_out, g["readout1"]), g["readout2"])


class GPNTestOut(NamedTuple):
    scores: torch.Tensor      # [..., S]
    read_out: torch.Tensor    # [..., S, 2L] pooled read-out (pre-projection)
    att_masks: torch.Tensor   # [..., S, N]


def node_membership(sub_obj_ind, sub_att_mask, n_obj: int):
    """[..., S, N] indices + mask -> [..., S, n_obj] {0,1} node-set
    membership matrix."""
    mem = (one_hot(sub_obj_ind, n_obj) * sub_att_mask[..., None]).sum(-2)
    return torch.clamp(mem, max=1.0)


def gpn_test_forward(params, x_obj_img, sub_obj_ind, sub_att_mask,
                     cfg: ModelConfig) -> GPNTestOut:
    """Score all sub-graphs (gpn.py:83-97) before NMS.

    x_obj_img [..., n_obj, L]; sub_obj_ind/sub_att_mask [..., S, N].  The
    read-out pools through the node-set membership matrix: the mean as one
    matmul, the max over a masked broadcast (post-GCN node features are >= 0
    and node sets are duplicate-free, so both match the reference's gather).
    Under ``use_gt_subg`` (the Sup. model, which has no scorer) every score
    is 1.
    """
    n_obj = x_obj_img.shape[-2]
    mem = node_membership(sub_obj_ind, sub_att_mask, n_obj)     # [.., S, n]
    mean_feat = (mem @ x_obj_img) / sub_att_mask.sum(-1, keepdim=True)
    # the JAX package's literal masked max: non-members sit 1e30 below
    masked = (x_obj_img[..., None, :, :]
              + (mem[..., :, :, None] - 1.0) * 1e30)
    max_feat = masked.amax(dim=-2)
    read_out = torch.cat([max_feat, mean_feat], dim=-1)
    if cfg.use_gt_subg:
        scores = torch.ones(sub_obj_ind.shape[:-1], dtype=torch.float32,
                            device=read_out.device)
    else:
        scores = gpn_score(params, read_out)
    return GPNTestOut(scores=scores, read_out=read_out,
                      att_masks=sub_att_mask)


def pairwise_node_iou(mem):
    """Pairwise node-set IoU from membership rows [..., S, n] (gpn.py:140-150)."""
    sizes = mem.sum(-1)
    inter = mem @ mem.transpose(-1, -2)
    union = sizes[..., :, None] + sizes[..., None, :] - inter
    return inter / torch.clamp(union, min=1.0)


def subgraph_nms(scores, sub_obj_ind, sub_att_mask, valid, cfg: ModelConfig,
                 iou_thres: float, max_keep: int,
                 parallel: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy score-descending sub-graph NMS (gpn.py:108-138), per image.

    scores/valid [B, S] (or [S]); sub_obj_ind/sub_att_mask [B, S, N].
    Returns (keep_ind [B, max_keep] int64 in ascending original order,
    keep_valid [B, max_keep] bool), with the leading axis dropped for 1-D
    input.

    * default: the parallel fixpoint.  In score order the keep set is the
      unique fixpoint of ``k[i] = valid[i] & ~any(j<i: k[j] & iou[j,i] >
      thres)``; Jacobi iteration from ``k0 = valid`` settles an item of
      suppression-chain depth d after d rounds.  Each round tests the stop
      condition on the host, so the batch iterates until all images settle
      (a settled image stays fixed).
    * ``parallel=False``: the sequential sweep, one confirmed keep per
      iteration — the reference's suppression loop truncated to max_keep.
    """
    single = scores.dim() == 1
    if single:
        scores, sub_obj_ind, sub_att_mask, valid = (
            x[None] for x in (scores, sub_obj_ind, sub_att_mask, valid))
    B, S = scores.shape
    dev = scores.device
    max_keep = min(max_keep, S)
    s = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    order = torch.sort(-s, dim=-1, stable=True).indices          # [B, S]
    mem = node_membership(sub_obj_ind, sub_att_mask, cfg.obj_num)
    valid_sorted = torch.gather(valid, 1, order)
    bix = torch.arange(B, device=dev)

    if not parallel:
        iou = pairwise_node_iou(mem)
        iou_sorted = iou[bix[:, None, None], order[:, :, None],
                         order[:, None, :]]
        alive = valid_sorted.clone()
        keep_sorted = torch.zeros_like(valid_sorted)
        for _ in range(max_keep):
            any_alive = alive.any(-1)
            i = torch.argmax(alive.to(torch.uint8), dim=-1)  # first alive
            keep_sorted[bix, i] |= any_alive
            alive &= ~(iou_sorted[bix, i] > iou_thres)
            alive[bix, i] = False
    else:
        iou_sorted = pairwise_node_iou(mem[bix[:, None], order])
        ar = torch.arange(S, device=dev)
        # sup[b, j, i]: valid j earlier in score order, IoU above threshold
        sup = ((iou_sorted > iou_thres) & (ar[:, None] < ar[None, :])
               & valid_sorted[:, :, None]).to(torch.float32)
        k, prev = valid_sorted, ~valid_sorted
        it = 0
        while it < S and bool((k != prev).any()):
            hit = (k.to(torch.float32)[:, None, :] @ sup)[:, 0] > 0.0
            k, prev = valid_sorted & ~hit, k
            it += 1
        # full-NMS keep truncated to the max_keep best (greedy prefix)
        rank = torch.cumsum(k.to(torch.int64), dim=-1) - 1
        keep_sorted = k & (rank < max_keep)

    # back to original indices, ascending original order
    idx = torch.arange(S, device=dev).expand(B, S)
    keep_orig = torch.zeros_like(keep_sorted).scatter(1, order, keep_sorted)
    sort_key = torch.where(keep_orig, idx, idx + S)
    packed = torch.sort(sort_key, dim=-1).indices[:, :max_keep]
    n_kept = torch.clamp(keep_orig.sum(-1), max=max_keep)
    keep_valid = torch.arange(max_keep, device=dev)[None] < n_kept[:, None]
    keep_ind = torch.where(keep_valid, packed, torch.zeros_like(packed))
    if single:
        return keep_ind[0], keep_valid[0]
    return keep_ind, keep_valid
