"""Show-Control-Tell (controllability) eval loader.

The port's own copy of ``subgc_tpu/data/sct.py`` (reference
`dataloaders/dataloader_test_sct.py`), numpy only: per image, match each
user/GT region set to detector boxes by box IoU, then build one sub-graph
per region set either greedily (seed nodes + same-class nodes + 1-hop
neighbour expansion; `dataloader_test_sct.py:313-355`) or by look-up of the
precomputed GT sub-graph whose seed-node set matches exactly
(`dataloader_test_sct.py:356-380`).  :func:`sct_subgraph_set` does the
per-image work on arrays, so callers without label files build the same
examples.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import DataConfig, ModelConfig
from ..graph import SubgraphSet
from .dataset import EvalLoader, ImageInfo, TestExample


def box_iou_single(a, b) -> float:
    """+1-extent IoU (dataloader_test_sct.py:207-226)."""
    xa, ya = max(a[0], b[0]), max(a[1], b[1])
    xb, yb = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, xb - xa + 1) * max(0.0, yb - ya + 1)
    area_a = (a[2] - a[0] + 1) * (a[3] - a[1] + 1)
    area_b = (b[2] - b[0] + 1) * (b[3] - b[1] + 1)
    return inter / float(area_a + area_b - inter)


def match_region_sets(region_sets, sg_boxes, iou_thres: float = 0.5
                      ) -> List[np.ndarray]:
    """Per region set, the matched detector node indices
    (dataloader_test_sct.py:266-295 incl. the adaptive-threshold fallback)."""
    out = []
    for rset in region_sets:
        valid = np.asarray(rset)[:, 4].nonzero()[0].shape[0]
        boxes = np.asarray(rset)[:valid, :4]
        matched = []
        for region in boxes:
            best_iou, best_k = 0.0, -1
            for k in range(sg_boxes.shape[0]):
                iou = box_iou_single(region, sg_boxes[k])
                if iou > best_iou:
                    best_iou, best_k = iou, k
            if best_k != -1:
                matched.append((best_k, best_iou))
        keep = [m for m, iou in matched if iou >= iou_thres]
        if not keep:
            adaptive = max((iou for _, iou in matched), default=0.0)
            if adaptive == 0.0:
                keep = list(range(sg_boxes.shape[0]))
            else:
                keep = [m for m, iou in matched if iou >= adaptive]
        out.append(np.asarray(keep, np.int64))
    return out


def greedy_subgraph(seed_nodes: np.ndarray, object_cls: np.ndarray,
                    rel_ind: np.ndarray):
    """Seed nodes -> same-class nodes -> neighbour closure
    (dataloader_test_sct.py:313-344).  Returns (obj_mask, rel_mask)."""
    keep_obj = np.zeros(object_cls.shape[0], np.int64)
    keep_obj[np.asarray(seed_nodes, np.int64)] = 1
    kept_cls = np.unique(object_cls[keep_obj == 1])
    keep_obj[np.isin(object_cls, kept_cls)] = 1
    keep_ind = keep_obj.nonzero()[0]

    keep_rel = (np.isin(rel_ind[:, 0], keep_ind)
                | np.isin(rel_ind[:, 1], keep_ind))
    keep_obj[np.unique(rel_ind[keep_rel])] = 1
    return keep_obj, keep_rel.astype(np.int64)


def sct_subgraph_set(region_sets, sg_boxes: np.ndarray,
                     object_cls: np.ndarray, rel_ind: np.ndarray,
                     obj_num: int, rel_num: int, bucket: int,
                     gt_masks=None) -> Tuple[SubgraphSet, int]:
    """One image's SCT sub-graphs: region sets [G, R, 5] (x1, y1, x2, y2,
    valid) matched to ``sg_boxes`` [n, 4] (already in the region sets'
    pixel scale), one sub-graph per set in set order, padded to ``bucket``.

    Greedy construction from ``object_cls`` [n] and ``rel_ind`` [k, 2]
    when ``gt_masks`` is None; otherwise the GT sub-graph of
    ``gt_masks[:5]`` (``subgraph_mask_list`` entries) whose seed-node set
    equals the matched nodes.  Returns (SubgraphSet, number of sets)."""
    match_ind = match_region_sets(region_sets, sg_boxes)
    if len(match_ind) > bucket:
        raise ValueError(f"{len(match_ind)} region sets exceed bucket "
                         f"{bucket}")
    obj_ind = np.full((bucket, obj_num), obj_num - 1, np.int32)
    att_mask = np.zeros((bucket, obj_num), np.float32)
    att_mask[:, 0] = 1.0       # padded slots keep the dummy node "live"
    pred_ind = np.full((bucket, rel_num), rel_num - 1, np.int32)
    valid = np.zeros((bucket,), bool)
    if gt_masks is not None:
        gt_seeds = [np.unique(np.asarray(mask[4])) for mask in gt_masks[:5]]

    for i, seeds in enumerate(match_ind):
        if gt_masks is None:
            obj_mask, rel_mask = greedy_subgraph(seeds, object_cls, rel_ind)
            onz = obj_mask.nonzero()[0]
            pnz = rel_mask.nonzero()[0]
        else:
            # match by exact seed-node set (dataloader_test_sct.py:356-372)
            uq = np.unique(seeds)
            matched = next((j for j, pre in enumerate(gt_seeds)
                            if uq.shape == pre.shape and (pre == uq).all()),
                           None)
            if matched is None:
                raise ValueError(f"no GT sub-graph matches region set {i}")
            onz = np.asarray(gt_masks[matched][1]).nonzero()[0]
            pnz = np.asarray(gt_masks[matched][2]).nonzero()[0]
        att_mask[i] = 0.0
        obj_ind[i, :onz.shape[0]] = onz
        att_mask[i, :onz.shape[0]] = 1.0
        pred_ind[i, :pnz.shape[0]] = pnz
        valid[i] = True
    return SubgraphSet(obj_ind=obj_ind, pred_ind=pred_ind, att_mask=att_mask,
                       valid=valid), len(match_ind)


class SCTLoader(EvalLoader):
    """Controllability loader: one sub-graph per GT region set.

    sct_dict: {str(img_id): [G, R, 5] region sets (x1,y1,x2,y2,valid)},
    img_wh: {img_id: (w, h)} — the reference's
    sct_dict_test_grouped_gt_box.npy / flickr30k_img_wh.npy contents.
    """

    def __init__(self, mcfg: ModelConfig, dcfg: DataConfig, sct_dict: Dict,
                 img_wh: Dict, use_greedy_subg: bool = True,
                 use_gt_subg: bool = False, bucket: int = 32,
                 seed: int = 2019):
        if not (use_greedy_subg or use_gt_subg):
            raise ValueError("SCTLoader builds sub-graphs greedily "
                             "(use_greedy_subg) or looks up GT ones "
                             "(use_gt_subg)")
        super().__init__(mcfg, dcfg, bucket=bucket, seed=seed)
        self.sct_dict = sct_dict
        self.img_wh = img_wh
        self.use_greedy_subg = use_greedy_subg
        self.use_gt_subg = use_gt_subg

    def example(self, pos: int, split: str = "test") -> TestExample:
        ix = self.split_ix[split][pos]
        img = self.ds.images[ix]
        img_id = img["id"]
        m = self.mcfg

        graph, sg_raw = self._scene_graph(img_id)
        w, h = self.img_wh[img_id]
        sg_boxes = np.asarray(sg_raw["boxes"])[:m.obj_num] * max(w, h) / 592.0
        object_cls = np.argmax(np.asarray(sg_raw["object_dist"])[:m.obj_num],
                               axis=1)
        gt_masks: Optional[list] = None
        if not self.use_greedy_subg:
            gt_masks = self.masks.get(img_id)["subgraph_mask_list"]
        try:
            subs, n = sct_subgraph_set(
                np.asarray(self.sct_dict[str(img_id)]), sg_boxes, object_cls,
                np.asarray(sg_raw["rel_ind"], np.int64), m.obj_num, m.rel_num,
                self.bucket, gt_masks)
        except ValueError as e:
            raise ValueError(f"image {img_id}: {e}") from None
        return TestExample(graph=graph, subs=subs, n_subgraphs=n,
                           info=ImageInfo(ix=ix, id=img_id,
                                          file_path=img["file_path"]),
                           gts=self.ds.captions_for(ix), sg_raw=sg_raw)
