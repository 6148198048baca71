"""Packed shards behind the npz-dict interface of the loaders.

The counterpart of ``subgc_tpu/data/packed_adapter.py``: ``TrainLoader`` and
``EvalLoader`` read one or more mmap'ed shards in place of the per-image npz
directories, with their logic unchanged: ``.get(img_id)`` returns dicts
shaped like the npz payloads, and ``PackedMaskSource.get_fast`` the shard's
left-packed sub-graph rows, which the loaders gather directly.
"""
from __future__ import annotations

import glob
from typing import Dict

import numpy as np

from .packed import PackedShard


class PackedSource:
    """One shard path, or a glob / comma list of shards packed in parallel
    (each mmap'ed on its own; the image-id index spans them all)."""

    def __init__(self, path: str, use_native: bool = True):
        if "," in path:
            paths = path.split(",")
        elif any(c in path for c in "*?["):
            paths = sorted(glob.glob(path))
        else:
            paths = [path]
        if not paths:
            raise FileNotFoundError(f"no shards match {path!r}")
        self.shards = [PackedShard(p, use_native=use_native) for p in paths]
        self.shard = self.shards[0]
        self.index = {}
        for si, sh in enumerate(self.shards):
            for i, v in enumerate(sh.image_ids()):
                self.index[int(v)] = (si, i)

    def _rec(self, img_id):
        si, i = self.index[int(img_id)]
        return self.shards[si].record(i)


class PackedSGSource(PackedSource):
    """The sg_output npz interface: object_fmap / object_dist / rel_ind /
    pred_dist / boxes."""

    def get(self, img_id) -> Dict[str, np.ndarray]:
        r = self._rec(img_id)
        n, k = int(r["counts"][0]), int(r["counts"][1])
        return {"object_fmap": r["obj_fmap"][:n],
                "object_dist": r["obj_dist"][:n],
                "rel_ind": r["rel_ind"][:k],
                "pred_dist": r["pred_dist"][:k],
                "boxes": r["boxes"]}


class PackedMaskSource(PackedSource):
    """The graph_mask npz interface: node_iou_mtx + subgraph_mask_list."""

    def get(self, img_id) -> Dict:
        r = self._rec(img_id)
        total = 5 + int(r["counts"][2])
        obj_num = self.shard.spec.obj_num
        rel_num = self.shard.spec.rel_num
        entries = []
        for i in range(total):
            obj_mask = np.zeros(obj_num - 1, np.int64)
            nodes = r["sub_obj_ind"][i][r["sub_att_mask"][i] > 0]
            obj_mask[nodes[nodes < obj_num - 1]] = 1
            pred_mask = np.zeros(rel_num - 1, np.int64)
            # padded slots hold rel_num-1; valid ones were left-packed
            valid_rels = []
            for v in r["sub_pred_ind"][i]:
                if v == rel_num - 1:
                    break
                valid_rels.append(int(v))
            pred_mask[valid_rels] = 1
            entries.append([None, obj_mask, pred_mask,
                            np.zeros((0, 2), np.int64), nodes[:1]])
        return {"node_iou_mtx": r["node_iou"][:, :total],
                "subgraph_mask_list": entries}

    def get_fast(self, img_id) -> Dict:
        """The shard's rows as stored: sub-graphs already left-packed in the
        model's layout, for the loaders to gather without rebuilding dense
        masks (``get`` exists for the npz interface)."""
        r = self._rec(img_id)
        total = 5 + int(r["counts"][2])
        return {"node_iou_mtx": r["node_iou"][:, :total],
                "sub_obj_ind": r["sub_obj_ind"][:total],
                "sub_att_mask": r["sub_att_mask"][:total],
                "sub_pred_ind": r["sub_pred_ind"][:total],
                "total": total}
