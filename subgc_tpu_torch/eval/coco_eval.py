"""COCO-caption style evaluator with cached tokenized GTs.

Python equivalent of the reference's modified vendored `COCOEvalCap`
(`misc/coco-caption/pycocoevalcap/eval.py:15-120`): GT captions are
tokenized once and many caption sets can be re-evaluated against them (the
per-rank loop of `misc/sentence_utils.py:95-111` calls evaluate() top-k
times).  All scorers are the framework's own reimplementations — no Java
subprocesses.

The port's own copy of ``subgc_tpu/eval/coco_eval.py``, held equal to it
by ``tests/test_torch_port_scorers.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .bleu import compute_bleu
from .cider import compute_cider
from .meteor import compute_meteor
from .rouge import compute_rouge
from .spice import compute_spice
from .tokenizer import tokenize


class CaptionEvaluator:
    """gts: {image_id: [raw caption strings]} (untokenized)."""

    def __init__(self, gts_raw: Dict[object, List[str]],
                 image_ids: Optional[List] = None,
                 use_spice: bool = True, use_meteor: bool = True,
                 tokenize_fn=None, meteor_fn=None, spice_fn=None):
        """tokenize_fn/meteor_fn/spice_fn override the framework scorers —
        used by tools/metric_bounds.py to measure scorer divergences in
        end-metric units (same pipeline, one component swapped)."""
        self._tokenize = tokenize_fn or tokenize
        self._meteor = meteor_fn or compute_meteor
        self._spice = spice_fn or compute_spice
        self.image_ids = list(image_ids) if image_ids is not None \
            else list(gts_raw.keys())
        self.gts = self._tokenize({k: [{"caption": c} for c in gts_raw[k]]
                                   for k in self.image_ids})
        self.use_spice = use_spice
        self.use_meteor = use_meteor
        self.eval: Dict[str, float] = {}
        self.eval_scores: Dict[str, np.ndarray] = {}
        self.subgraph_training_bleu = None

    def evaluate(self, res_raw: Dict[object, str]) -> Dict[str, float]:
        """res_raw: {image_id: caption string} for every image_id."""
        res = self._tokenize({k: [{"caption": res_raw[k]}]
                              for k in self.image_ids})
        gts = {k: self.gts[k] for k in self.image_ids}

        corpus_bleu, per_img_bleu, material = compute_bleu(gts, res)
        self.subgraph_training_bleu = material
        for k in range(4):
            self.eval[f"Bleu_{k + 1}"] = corpus_bleu[k]
            self.eval_scores[f"Bleu_{k + 1}"] = np.asarray(per_img_bleu[k])

        if self.use_meteor:
            m, ms = self._meteor(gts, res)
            self.eval["METEOR"] = m
            self.eval_scores["METEOR"] = ms
        r, rs = compute_rouge(gts, res)
        self.eval["ROUGE_L"] = r
        self.eval_scores["ROUGE_L"] = rs
        c, cs = compute_cider(gts, res)
        self.eval["CIDEr"] = c
        self.eval_scores["CIDEr"] = cs
        if self.use_spice:
            s, ss, _ = self._spice(gts, res)
            self.eval["SPICE"] = s
            self.eval_scores["SPICE"] = ss
        return dict(self.eval)
