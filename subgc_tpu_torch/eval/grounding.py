"""Flickr30k-Entities grounding evaluation + material collection.

The port's own copy of ``subgc_tpu/eval/grounding.py`` (numpy only).  Two
parts, mirroring the reference:

* ``GroundingCollector`` — builds `grounding_file.json` from attention
  weights during decode (`misc/grd_utils.py:13-61`): per word, attention
  argmax -> sub-graph node -> full-graph node -> detector box (rescaled by
  max(w,h)/592), with word -> lemma -> detection-class mapping.
* ``FlickrGrdEval`` — precision (with hallucination penalty in 'all' mode),
  recall and F1 at IoU 0.5 (`misc/grounding/eval_grd_flickr30k_entities.py`),
  with numpy box IoU and the built-in rule lemmatizer instead of the
  CoreNLP server.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np

from ..utils.lemma import lemmatize


def box_iou(box: np.ndarray, ref_boxes: np.ndarray) -> np.ndarray:
    """IoU of one [4] box vs [R,4] boxes (tools/bbox_transform.py:175
    semantics: +1 extents)."""
    ref_boxes = np.atleast_2d(ref_boxes)
    ix = (np.minimum(box[2], ref_boxes[:, 2])
          - np.maximum(box[0], ref_boxes[:, 0]) + 1).clip(0)
    iy = (np.minimum(box[3], ref_boxes[:, 3])
          - np.maximum(box[1], ref_boxes[:, 1]) + 1).clip(0)
    inter = ix * iy
    area = (box[2] - box[0] + 1) * (box[3] - box[1] + 1)
    ref_area = (ref_boxes[:, 2] - ref_boxes[:, 0] + 1) \
        * (ref_boxes[:, 3] - ref_boxes[:, 1] + 1)
    return inter / (area + ref_area - inter)


class GroundingCollector:
    """collect_grounding callback for eval.runner.run_test_split (the
    port's tensors arrive there as numpy arrays)."""

    def __init__(self, wd_to_lemma: Dict[str, str],
                 lemma_det_id_dict: Dict[str, int],
                 det_id_to_det_wd: Dict[int, str],
                 img_wh: Dict[int, tuple],
                 rerank_ind: Optional[Dict] = None):
        self.wd_to_lemma = wd_to_lemma
        self.lemma_det_id = lemma_det_id_dict
        self.det_id_to_wd = det_id_to_det_wd
        self.img_wh = img_wh
        self.rerank_ind = rerank_ind     # consensus_rerank_ind.npy contents
        self.output = defaultdict(list)

    def __call__(self, example, sents, sorted_subgraph_ind, att_weights, order):
        img_id = example.info.id
        w, h = self.img_wh[img_id]
        boxes = np.asarray(example.sg_raw["boxes"]) * max(w, h) / 592.0

        # best sentence: sGPN rank 0, or consensus top-1 (grd_utils.py:30-36)
        sent_index = 0
        if self.rerank_ind is not None and img_id in self.rerank_ind:
            sent_index = int(self.rerank_ind[img_id][0])

        sent_used = sents[sent_index]
        words = sent_used.split()
        # nodes of the chosen sub-graph, in full-graph index space
        sub = np.asarray(example.subs.obj_ind)[sorted_subgraph_ind[sent_index]]
        mask = np.asarray(example.subs.att_mask)[sorted_subgraph_ind[sent_index]]
        obj_ind_this = sub[mask > 0]

        att = np.asarray(att_weights[sent_index])       # [T+1, N]
        att2_ind = att.argmax(axis=1)[:len(words)]

        entry = {"clss": [], "idx_in_sent": [], "bbox": []}
        for j, wd in enumerate(words):
            if wd not in self.wd_to_lemma:
                continue
            lemma = self.wd_to_lemma[wd]
            if lemma in self.lemma_det_id:
                node = int(att2_ind[j])
                full_node = int(obj_ind_this[node]) if node < len(obj_ind_this) \
                    else int(sub[node])
                if full_node >= boxes.shape[0]:
                    continue       # attention on the dummy/padded slot
                entry["bbox"].append(boxes[full_node].tolist())
                entry["clss"].append(self.det_id_to_wd[self.lemma_det_id[lemma]])
                entry["idx_in_sent"].append(j)
        self.output[str(img_id)].append(entry)

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump({"results": dict(self.output), "eval_mode": "gen",
                       "external_data": {"used": True,
                                         "details": "grounding experiment"}}, f)


class FlickrGrdEval:
    """Precision/recall/F1 at IoU>thresh over Flickr30k Entities annotations.

    ref: [{'image_id', 'captions': [{'process_bnd_box', 'process_idx',
          'process_clss', 'tokens'}]}] — the flickr30k_cleaned_class format.
    pred: {'<img_id>': [{'clss', 'idx_in_sent', 'bbox'}]}.
    """

    def __init__(self, ref: List[dict], pred: Dict[str, list],
                 iou_thresh: float = 0.5,
                 lemma_fn: Callable[[str], str] = lemmatize):
        self.ref = ref
        self.pred = pred
        self.iou_thresh = iou_thresh
        self.lemma = lemma_fn

    def _hit(self, pred_bbox, ref_bbox) -> int:
        return 1 if box_iou(np.asarray(pred_bbox, np.float64),
                            np.asarray(ref_bbox, np.float64)).max() \
            > self.iou_thresh else 0

    def grd_eval(self, mode: str = "all") -> dict:
        assert mode in ("all", "loc")
        vocab_in_split = set()
        prec = defaultdict(list)
        for anns in self.ref:
            img = str(anns["image_id"])
            for ann in anns["captions"]:
                if img not in self.pred:
                    continue
                ref_bbox_all = ann["process_bnd_box"]
                idx_in_sent: Dict[str, list] = {}
                for box_idx, cls in enumerate(ann["process_clss"]):
                    vocab_in_split.add(cls)
                    idx_in_sent.setdefault(cls, []).append(
                        ann["process_idx"][box_idx])
                sent_idx = ann["process_idx"]
                exclude_obj = {self.lemma(tok): 1
                               for ti, tok in enumerate(ann["tokens"])
                               if ti not in sent_idx and tok != ""}
                for pred_idx, cls in enumerate(self.pred[img][0]["clss"]):
                    if cls in idx_in_sent:
                        gt_idx = min(idx_in_sent[cls])
                        sel = [i for i, x in enumerate(ann["process_idx"])
                               if x == gt_idx]
                        prec[cls].append(self._hit(
                            self.pred[img][0]["bbox"][pred_idx],
                            ref_bbox_all[sel[0]]))
                    elif self.lemma(cls) in exclude_obj:
                        pass       # missed annotation: no penalty
                    elif mode == "all":
                        prec[cls].append(0)     # hallucinated object

        recall = defaultdict(list)
        for anns in self.ref:
            img = str(anns["image_id"])
            for ann in anns["captions"]:
                ref_bbox_all = ann["process_bnd_box"]
                for gt_idx in ann["process_idx"]:
                    sel = [i for i, x in enumerate(ann["process_idx"])
                           if x == gt_idx]
                    cls = ann["process_clss"][sel[0]]
                    if img not in self.pred:
                        recall[cls].append(0)
                    elif cls in self.pred[img][0]["clss"]:
                        pred_idx = self.pred[img][0]["clss"].index(cls)
                        recall[cls].append(self._hit(
                            self.pred[img][0]["bbox"][pred_idx],
                            ref_bbox_all[sel[0]]))
                    elif mode == "all":
                        recall[cls].append(0)

        num_vocab = len(vocab_in_split)
        if num_vocab == 0:
            # empty reference (e.g., a model emitting empty captions left
            # no grounded classes to score) — all-zero rather than crash
            return {f"precision_{mode}": 0.0, f"recall_{mode}": 0.0,
                    f"F1_{mode}": 0.0}
        prec_accu = sum(sum(h) / len(h) for h in prec.values()) / num_vocab
        rec_accu = sum(sum(h) / len(h) for h in recall.values()) / num_vocab
        f1 = 2 * prec_accu * rec_accu / (prec_accu + rec_accu) \
            if prec_accu + rec_accu > 0 else 0.0
        return {f"precision_{mode}": prec_accu, f"recall_{mode}": rec_accu,
                f"F1_{mode}": f1}
