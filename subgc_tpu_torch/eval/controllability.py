"""Controllability scoring (misc/controllability/).

Reimplements `controllability_score.py` + `noun_iou.py` without the speaksee
/munkres pip deps: re-order generated region-set captions to the GT group
order, score BLEU/METEOR/ROUGE/CIDEr/SPICE with the framework's scorers, and
compute the noun-IoU metric (GloVe cosine similarity + Hungarian assignment,
here via scipy.optimize.linear_sum_assignment).

The port's own copy of ``subgc_tpu/eval/controllability.py``, held equal to it
by ``tests/test_torch_port_metrics.py``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .bleu import compute_bleu
from .cider import compute_cider
from .meteor import compute_meteor
from .rouge import compute_rouge
from .spice import compute_spice
from .tokenizer import tokenize


class NounIoU:
    """Soft noun-set IoU (noun_iou.py:6-47).

    vectors: {word: np.ndarray} — GloVe vectors restricted to nouns (the
    reference ships them as flickr_noun_glove.pkl).
    """

    def __init__(self, vectors: Dict[str, np.ndarray]):
        self.vectors = {k: np.asarray(v, np.float64) for k, v in vectors.items()}

    def _prep(self, seq: str) -> List[str]:
        return [w for w in seq.split(" ") if w in self.vectors]

    def score(self, seq_gt: str, seq_pred: str) -> float:
        gt = self._prep(seq_gt)
        pred = self._prep(seq_pred)
        m, n = len(gt), len(pred)
        if m == 0:
            return 1.0
        if n == 0:
            return 0.0
        sim = np.zeros((m, n))
        for i, a in enumerate(gt):
            va = self.vectors[a]
            for j, b in enumerate(pred):
                vb = self.vectors[b]
                sim[i, j] = float(va @ vb / (np.linalg.norm(va)
                                             * np.linalg.norm(vb) + 1e-12))
        sim = (sim + 1.0) / 2.0
        from scipy.optimize import linear_sum_assignment
        rows, cols = linear_sum_assignment(-sim)
        inter = float(sim[rows, cols].sum())
        return inter / (m + n - inter)


def controllability_scores(predictions: List[dict], order_list: Sequence,
                           gt_caption_groups: List[List[str]],
                           noun_iou: NounIoU,
                           use_spice: bool = True) -> dict:
    """predictions: ctl_captions list [{'image_id', 'caption': [...]}] where
    captions are in grouped-GT order per image; order_list: image-id order;
    gt_caption_groups: flat list aligned with the flattened ordered captions
    (controllability_score.py:28-53)."""
    sen_dict = {str(p["image_id"]): p["caption"] for p in predictions}
    order_sent: List[str] = []
    for img_id in order_list:
        order_sent.extend(sen_dict[str(img_id)])
    assert len(order_sent) == len(gt_caption_groups)

    gts = {}
    gen = {}
    iou_scores = []
    for i, cap in enumerate(order_sent):
        gts[i] = gt_caption_groups[i]
        gen[i] = [cap]
        s = sum(noun_iou.score(c, cap) for c in gt_caption_groups[i])
        iou_scores.append(s / len(gt_caption_groups[i]))

    gts_t = tokenize({k: [{"caption": c} for c in v] for k, v in gts.items()})
    gen_t = tokenize({k: [{"caption": c} for c in v] for k, v in gen.items()})

    out = {}
    corpus, _, _ = compute_bleu(gts_t, gen_t)
    for k in range(4):
        out[f"Bleu_{k + 1}"] = corpus[k]
    out["METEOR"], _ = compute_meteor(gts_t, gen_t)
    out["ROUGE_L"], _ = compute_rouge(gts_t, gen_t)
    out["CIDEr"], _ = compute_cider(gts_t, gen_t)
    if use_spice:
        out["SPICE"], _, _ = compute_spice(gts_t, gen_t)
    out["NounIoU"] = float(np.mean(iou_scores))
    return out
