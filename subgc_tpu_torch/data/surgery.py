"""Offline scene-graph export: detector/SGG output -> the 64-triplet npz.

The counterpart of ``subgc_tpu/data/surgery.py``, reimplementing the
filtering of `misc/surgery.py:19-125` (the offline hook the reference runs
inside an external Graph-RCNN checkout): given one image's detector
boxes / features / class distributions and the SGG relation scores, keep the
top-64 relations ranked by pred_score * subject_score * object_score after
thresholding the non-background relation probability.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..io.sg_npz import write_feat_npz


def filter_dets(boxes: np.ndarray, obj_scores: np.ndarray,
                obj_dist: np.ndarray, obj_fmap: np.ndarray,
                rel_inds: np.ndarray, pred_scores: np.ndarray,
                nonbg_thresh: float = 0.75, max_rels: int = 64,
                max_objs: int = 36) -> Dict[str, np.ndarray]:
    """One image's raw detections -> the npz 'feat' dict.

    boxes [n,4]; obj_scores [n]; obj_dist [n,C_obj]; obj_fmap [n,D];
    rel_inds [k,2]; pred_scores [k,C_rel] (col 0 = background/no-relation).
    Relations whose non-background probability exceeds ``nonbg_thresh``
    (all of them, where none does) are ranked by the best non-background
    score times both objects' scores, in a stable order; the top
    ``max_rels`` survive.
    """
    boxes = boxes[:max_objs]
    obj_scores = obj_scores[:max_objs]
    obj_dist = obj_dist[:max_objs]
    obj_fmap = obj_fmap[:max_objs]

    keep = (rel_inds[:, 0] < max_objs) & (rel_inds[:, 1] < max_objs)
    rel_inds = rel_inds[keep]
    pred_scores = pred_scores[keep]

    nonbg = 1.0 - pred_scores[:, 0]
    mask = nonbg > nonbg_thresh
    if not mask.any():      # fall back to the best-scoring relations
        mask = np.ones_like(nonbg, bool)
    rel_inds = rel_inds[mask]
    pred_scores = pred_scores[mask]

    pred_best = pred_scores[:, 1:].max(axis=1)
    triplet_score = pred_best * obj_scores[rel_inds[:, 0]] \
        * obj_scores[rel_inds[:, 1]]
    order = np.argsort(-triplet_score, kind="stable")[:max_rels]

    return {
        "object_fmap": obj_fmap.astype(np.float32),
        "object_dist": obj_dist.astype(np.float32),
        "pred_dist": pred_scores[order].astype(np.float32),
        "rel_ind": rel_inds[order].astype(np.int64),
        "boxes": boxes.astype(np.float32),
    }


def export_image(out_dir: str, img_id, **det_arrays) -> str:
    """filter_dets + write ``<out_dir>/<img_id>.npz`` in the dataset format."""
    os.makedirs(out_dir, exist_ok=True)
    feat = filter_dets(**det_arrays)
    path = os.path.join(out_dir, f"{img_id}.npz")
    write_feat_npz(path, feat)
    return path
