"""Sub-graph proposal network (sGPN): training branch, test path and
sub-graph NMS.

The counterpart of ``subgc_tpu/models/gpn.py`` (reference
`models/lib/gpn.py`).  Every test-path function takes optional leading
image axes, so the per-image ``vmap`` of the JAX package is a batch
dimension here: NMS runs for a whole image batch at once, and its parallel
fixpoint iterates until every image in the batch has converged.  The
training branch scores each sentence's positive and negative sub-graphs,
with the BCE loss in its softplus form.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import ModelConfig
from ..ops import sgpn as SG
from ..parallel import distributed as DP
from ..utils.profiling import span
from .encoder import one_hot


def _dense(x, p):
    return x @ p["w"] + p["b"]


def graph_pooling(gpn_att, att_mask):
    """Masked max + mean pooling over sub-graph nodes (gpn.py:174-185).

    gpn_att [..., N, L], att_mask [..., N] -> [..., 2L].  Features are
    zeroed outside the mask and the max runs over every row (post-GCN
    features are >= 0, so a zeroed row never wins against the reference's
    bmm)."""
    clean = gpn_att * att_mask[..., None]
    max_feat = clean.amax(dim=-2)
    mean_feat = clean.sum(-2) / att_mask.sum(-1, keepdim=True)
    return torch.cat([max_feat, mean_feat], dim=-1)


def gpn_score(params, read_out, train: bool = False, generator=None,
              return_logits: bool = False):
    """MLP + sigmoid sub-graph score (gpn.py:50-55).  In training with a
    ``generator``, the hidden layer takes the reference's fixed 0.5 dropout
    (keep with probability 0.5, scale 2).  ``return_logits`` also returns
    the pre-sigmoid logits, for the softplus form of :func:`bce_loss`."""
    g = params["gpn"]
    h = torch.relu(_dense(read_out, g["fc1"]))
    if train and generator is not None:
        keep = DP.rand_rows(h.shape, generator, h.device) < 0.5
        h = torch.where(keep, h * 2.0, torch.zeros_like(h))
    logits = _dense(h, g["fc2"])[..., 0]
    scores = torch.sigmoid(logits)
    return (scores, logits) if return_logits else scores


def bce_loss(scores, targets, eps_clamp: float = 100.0, logits=None):
    """torch.nn.BCELoss with its log clamp at -100 (gpn.py:33,57).

    Given ``logits``, the logs are written in the softplus form (log
    sigmoid(x) = -softplus(-x)): the same clamped values, but the gradient
    stays finite when the sigmoid saturates to exactly 0 or 1 in float32.
    Training uses this form.  The score form keeps the JAX package's guard
    at the saturated endpoints (an inner ``where`` keeps ``log`` off 0), so
    that its gradient is zero there and not 0 * inf = NaN, the NaN that
    once ended long training runs at step ~248.
    """
    if logits is not None:
        zero = torch.zeros_like(logits)
        log_s = torch.clamp(-torch.logaddexp(-logits, zero), min=-eps_clamp)
        log_1s = torch.clamp(-torch.logaddexp(logits, zero), min=-eps_clamp)
    else:
        pos, below = scores > 0.0, scores < 1.0
        const = torch.full_like(scores, -eps_clamp)
        log_s = torch.where(
            pos, torch.clamp(torch.log(torch.where(pos, scores,
                                                   torch.ones_like(scores))),
                             min=-eps_clamp), const)
        log_1s = torch.where(
            below, torch.clamp(torch.log1p(-torch.where(
                below, scores, torch.zeros_like(scores))), min=-eps_clamp),
            const)
    nll = -(targets * log_s + (1.0 - targets) * log_1s)
    group = DP.active_group()
    if group is None:
        return nll.mean()
    # a data-parallel rank: its sum over the global entry count
    count = DP.all_reduce_sum(torch.full((), float(nll.numel()),
                                         device=nll.device), group)
    return nll.sum() / count


def readout_project(params, read_out):
    """read_out_proj: 2L -> hid -> 2L, two Linears, no activation
    (gpn.py:35-38)."""
    g = params["gpn"]
    return _dense(_dense(read_out, g["readout1"]), g["readout2"])


def gpn_train_forward(params, x_obj, sub_obj_ind, sub_att_mask, img_ix,
                      cfg: ModelConfig, train: bool = True, generator=None):
    """Training branch (gpn.py:41-81).

    x_obj [B, N, L] per-image GCN node features; sub_obj_ind / sub_att_mask
    [S, 2, half, N] each sentence's positive (slot 0) and negative (slot 1)
    sub-graphs; img_ix [S] the image of each sentence.

    Returns (gpn_loss, scores [S, 2, half], att_feats [S, N, L], fc_feats
    [S, 2L], att_masks [S, N], chosen_ind [S, N]) for the highest-scoring
    positive of each sentence (the first on ties), whose read-out is
    detached before the projection, as in the reference; chosen_ind, its
    node indices, is what the JAX function appends under
    ``return_chosen=True`` (``share_att_train`` builds its node-set
    membership from it).  Under ``use_gt_subg`` every score is 1 (so the first
    positive is chosen) and gpn_loss is None.
    """
    S, two, half, N = sub_obj_ind.shape
    gathered = x_obj[img_ix[:, None, None, None], sub_obj_ind]
    read_out = graph_pooling(gathered, sub_att_mask)           # [S,2,half,2L]
    if cfg.use_gt_subg:
        scores = torch.ones((S, two, half), dtype=torch.float32,
                            device=x_obj.device)
        gpn_loss = None
    else:
        scores, logits = gpn_score(params, read_out, train, generator,
                                   return_logits=True)
        targets = torch.stack([torch.ones_like(scores[:, 0]),
                               torch.zeros_like(scores[:, 1])], dim=1)
        gpn_loss = bce_loss(scores, targets, logits=logits)
    best = torch.argmax(scores[:, 0, :], dim=-1)               # first max
    ar = torch.arange(S, device=x_obj.device)
    chosen_ind = sub_obj_ind[ar, 0, best]                      # [S, N]
    att_feats = x_obj[img_ix[:, None], chosen_ind]             # [S, N, L]
    att_masks = sub_att_mask[ar, 0, best]
    fc_feats = readout_project(params, read_out[ar, 0, best].detach())
    return gpn_loss, scores, att_feats, fc_feats, att_masks, chosen_ind


class GPNTestOut(NamedTuple):
    scores: torch.Tensor      # [..., S]
    read_out: torch.Tensor    # [..., S, 2L] pooled read-out (pre-projection)
    att_masks: torch.Tensor   # [..., S, N]


def node_membership(sub_obj_ind, sub_att_mask, n_obj: int):
    """[..., S, N] indices + mask -> [..., S, n_obj] {0,1} node-set
    membership matrix."""
    mem = (one_hot(sub_obj_ind, n_obj) * sub_att_mask[..., None]).sum(-2)
    return torch.clamp(mem, max=1.0)


def _on_card(t) -> bool:
    """The sGPN test path's route: the kernels of ``ops/sgpn.py`` for CUDA
    tensors (they raise on what they do not take), torch ops elsewhere."""
    return t.device.type == "cuda"


def masked_max(x_obj_img, mem):
    """The read-out's max half by torch ops: x_obj_img [..., n_obj, L] and
    membership mem [..., S, n_obj] -> [..., S, L], the JAX package's
    literal masked max (non-members sit 1e30 below)."""
    masked = (x_obj_img[..., None, :, :]
              + (mem[..., :, :, None] - 1.0) * 1e30)
    return masked.amax(dim=-2)


def gpn_test_forward(params, x_obj_img, sub_obj_ind, sub_att_mask,
                     cfg: ModelConfig) -> GPNTestOut:
    """Score all sub-graphs (gpn.py:83-97) before NMS.

    x_obj_img [..., n_obj, L]; sub_obj_ind/sub_att_mask [..., S, N].  The
    read-out pools through the node-set membership matrix: the mean as one
    matmul, the max over a masked broadcast (:func:`masked_max`; post-GCN
    node features are >= 0 and node sets are duplicate-free, so both match
    the reference's gather).  On the card the max is
    ``ops/sgpn.py::readout_max``'s kernel, the same terms read straight
    from the node lists and written into its half of the read-out, bit for
    bit the broadcast's.  Under ``use_gt_subg`` (the Sup. model, which has
    no scorer) every score is 1.
    """
    n_obj, L = x_obj_img.shape[-2:]
    mem = node_membership(sub_obj_ind, sub_att_mask, n_obj)     # [.., S, n]
    count = sub_att_mask.sum(-1, keepdim=True)
    if _on_card(x_obj_img):
        read_out = x_obj_img.new_empty(mem.shape[:-1] + (2 * L,))
        torch.div(mem @ x_obj_img, count, out=read_out[..., L:])
        SG.readout_max(x_obj_img, sub_obj_ind, sub_att_mask,
                       out=read_out[..., :L])
    else:
        read_out = torch.cat([masked_max(x_obj_img, mem),
                              (mem @ x_obj_img) / count], dim=-1)
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


def _keep_sorted_torch(order, sub_obj_ind, sub_att_mask, valid,
                       cfg: ModelConfig, iou_thres: float, max_keep: int,
                       parallel: bool):
    """:func:`subgraph_nms`'s keep set [B, S] in score order ``order``, by
    torch ops: the parallel fixpoint or the sequential sweep."""
    B, S = order.shape
    dev = order.device
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
        return keep_sorted
    iou_sorted = pairwise_node_iou(mem[bix[:, None], order])
    ar = torch.arange(S, device=dev)
    # sup[b, j, i]: valid j earlier in score order, IoU above threshold
    sup = ((iou_sorted > iou_thres) & (ar[:, None] < ar[None, :])
           & valid_sorted[:, :, None]).to(torch.float32)
    k, prev = valid_sorted, ~valid_sorted
    for _ in range(S):
        with span("subgc.gpn.nms_round"):
            if not bool((k != prev).any()):
                break
            hit = (k.to(torch.float32)[:, None, :] @ sup)[:, 0] > 0.0
            k, prev = valid_sorted & ~hit, k
    # full-NMS keep truncated to the max_keep best (greedy prefix)
    rank = torch.cumsum(k.to(torch.int64), dim=-1) - 1
    return k & (rank < max_keep)


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
      (a settled image stays fixed).  A round (a span of its own) is one
      test of the stop condition and, unless the batch has settled, one
      Jacobi step.
    * ``parallel=False``: the sequential sweep, one confirmed keep per
      iteration — the reference's suppression loop truncated to max_keep.

    Both give one keep set.  On the card, whichever ``parallel`` names, it
    comes from ``ops/sgpn.py::nms_keep_sorted``'s kernel: the greedy sweep
    in score order, stopped at max_keep, in one launch (one span
    ``subgc.gpn.nms_round``) with no host sync.
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
    if _on_card(scores):
        with span("subgc.gpn.nms_round"):
            keep_sorted = SG.nms_keep_sorted(order, sub_obj_ind, sub_att_mask,
                                             valid, iou_thres, max_keep,
                                             cfg.obj_num)
    else:
        keep_sorted = _keep_sorted_torch(order, sub_obj_ind, sub_att_mask,
                                         valid, cfg, iou_thres, max_keep,
                                         parallel)

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
