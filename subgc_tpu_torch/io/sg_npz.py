"""Scene-graph + sub-graph-mask npz IO in the reference's on-disk format.

Schemas (reference `misc/surgery.py:86-95`, `dataloaders/dataloader.py`):

* ``<sg_dir>/<img_id>.npz`` — single key ``feat`` holding a pickled dict:
  ``object_fmap [n<=36, 2048]``, ``object_dist [n, 1599]``,
  ``pred_dist [k<=64, 21]``, ``rel_ind [k, 2]``, ``boxes [n, 4]``.
* ``<mask_dir>/<img_id>.npz`` — key ``feat`` dict with
  ``node_iou_mtx [5, 5+S]`` and ``subgraph_mask_list`` (length 5+S), each
  entry a list whose [1]=object mask over 36 nodes, [2]=predicate mask over
  64 relations, [3]=re-indexed rel_ind, [4]=seed nodes.
"""
from __future__ import annotations

import os

import numpy as np


def read_feat_npz(path: str) -> dict:
    """np.load(...)['feat'].tolist() like HybridLoader (dataloader.py:26)."""
    with np.load(path, allow_pickle=True, encoding="latin1") as z:
        return z["feat"].tolist()


def write_feat_npz(path: str, feat: dict) -> None:
    """Write ``feat`` under the single pickled key ``feat``, as
    :func:`read_feat_npz` reads it."""
    np.savez(path, feat=np.asarray(feat, dtype=object))


class SGDir:
    """Directory-of-npz loader (reference HybridLoader, dataloader.py:14-37)."""

    def __init__(self, path: str):
        self.path = path

    def get(self, img_id) -> dict:
        return read_feat_npz(os.path.join(self.path, f"{img_id}.npz"))
