"""Fixed-shape scene-graph batch structures (numpy on the host).

The same two records as ``subgc_tpu/graph.py``:

* ``SceneGraph`` — the padded full graph per image (36 detections + 1 dummy
  node, 64 relations + 1 dummy; reference `dataloader.py:335-357`).
* ``SubgraphSet`` — a padded set of sub-graphs over those nodes: node and
  predicate indices with a validity mask.

Fields hold numpy arrays while the data is on the host and ``torch.Tensor``s
once :func:`to_device` has moved them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SceneGraph(NamedTuple):
    """Batched padded full scene graph.

    Shapes (B = images, N = obj_num (37), K = rel_num (65)):
      obj_fmap:  [B, N, 2048] float  — region features, dummy row last
      obj_dist:  [B, N, 1599] float  — class distribution; dummy row one-hot bg
      rel_ind:   [B, K, 2]    int    — (subject, object) node index per
                                       relation, padded with the dummy node
      pred_dist: [B, K, 21]   float  — predicate class distribution
    """
    obj_fmap: object
    obj_dist: object
    rel_ind: object
    pred_dist: object


class SubgraphSet(NamedTuple):
    """A padded set of sub-graphs indexing into a SceneGraph's nodes.

    Shapes ([..., S] = leading set dims, N = obj_num, K = rel_num):
      obj_ind:  [..., N] int   — node indices (first `count` real, rest N-1)
      pred_ind: [..., K] int   — relation indices (first real, rest K-1)
      att_mask: [..., N] float — 1.0 on real node slots
      valid:    [...]    bool  — whether this sub-graph slot is real
    """
    obj_ind: object
    pred_ind: object
    att_mask: object
    valid: object


def to_device(record, device):
    """Move a SceneGraph/SubgraphSet of numpy arrays onto ``device``
    (integer index arrays become int64, the dtype torch indexes with)."""
    out = []
    for x in record:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if t.dtype in (torch.int32, torch.int64):
            t = t.long()
        out.append(t.to(device))
    return type(record)(*out)


def make_scene_graph(obj_fmap: np.ndarray, obj_dist: np.ndarray,
                     rel_ind: np.ndarray, pred_dist: np.ndarray,
                     obj_num: int = 37, rel_num: int = 65) -> SceneGraph:
    """Pad one image's raw npz arrays to fixed shape (dataloader.py:335-357).

    The dummy node gets zero features and a background-one-hot class
    distribution; padded relations point at the dummy node with a
    background-one-hot predicate distribution.
    """
    n = min(obj_fmap.shape[0], obj_num - 1)
    k = min(rel_ind.shape[0], rel_num - 1)

    fmap = np.zeros((obj_num, obj_fmap.shape[1]), np.float32)
    fmap[:n] = obj_fmap[:n]
    dist = np.zeros((obj_num, obj_dist.shape[1]), np.float32)
    dist[:, 0] = 1.0
    dist[:n] = obj_dist[:n]
    rind = np.full((rel_num, 2), obj_num - 1, np.int32)
    rind[:k] = rel_ind[:k]
    pdist = np.zeros((rel_num, pred_dist.shape[1]), np.float32)
    pdist[:, 0] = 1.0
    pdist[:k] = pred_dist[:k]
    return SceneGraph(obj_fmap=fmap[None], obj_dist=dist[None],
                      rel_ind=rind[None], pred_dist=pdist[None])


def subgraphs_from_masks(obj_masks: np.ndarray, pred_masks: np.ndarray,
                         obj_num: int = 37, rel_num: int = 65) -> SubgraphSet:
    """Build a SubgraphSet from binary masks over nodes/relations, with the
    index packing of `dataloaders/dataloader.py:269-303`: nonzero indices
    left-packed, remaining slots hold the dummy index."""
    s = obj_masks.shape[0]
    obj_ind = np.full((s, obj_num), obj_num - 1, np.int32)
    att_mask = np.zeros((s, obj_num), np.float32)
    pred_ind = np.full((s, rel_num), rel_num - 1, np.int32)
    for i in range(s):
        nz = obj_masks[i].nonzero()[0]
        obj_ind[i, :nz.shape[0]] = nz
        att_mask[i, :nz.shape[0]] = 1.0
        pz = pred_masks[i].nonzero()[0]
        pred_ind[i, :pz.shape[0]] = pz
    return SubgraphSet(obj_ind=obj_ind, pred_ind=pred_ind, att_mask=att_mask,
                       valid=np.ones((s,), bool))


def pad_subgraph_set(sub: SubgraphSet, bucket: int) -> SubgraphSet:
    """Pad the sub-graph axis to a fixed bucket size."""
    s = sub.obj_ind.shape[0]
    if s > bucket:
        raise ValueError(f"{s} sub-graphs exceed bucket {bucket}")
    pad = bucket - s

    def _pad(x, fill):
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(np.asarray(x), widths, constant_values=fill)

    n = sub.obj_ind.shape[-1]
    k = sub.pred_ind.shape[-1]
    padded_mask = _pad(sub.att_mask, 0.0)
    # padded slots keep one "real" node (the dummy) so pooling denominators
    # and attention renormalization stay finite
    padded_mask[s:, 0] = 1.0
    return SubgraphSet(
        obj_ind=_pad(sub.obj_ind, n - 1),
        pred_ind=_pad(sub.pred_ind, k - 1),
        att_mask=padded_mask,
        valid=_pad(sub.valid, False),
    )
