"""Language eval over ranked caption lists + oracle top-k recompute.

Reimplements `misc/sentence_utils.py:28-129`: evaluate the rank-i caption of
every image for i in 0..top_k-1, then
* oracle BLEU: per image pick the rank maximizing its per-image BLEU, and
  recompute *corpus* BLEU from the picked images' raw components (cal_bleu,
  sentence_utils.py:28-53)
* oracle METEOR/ROUGE/CIDEr/SPICE: mean over images of the per-image max.

The port's own copy of ``subgc_tpu/eval/sentence.py``, held equal to it
by ``tests/test_torch_port_sentence.py``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from .bleu import bleu_from_components
from .coco_eval import CaptionEvaluator

BAD_ENDINGS = ['a', 'an', 'the', 'in', 'for', 'at', 'of', 'with', 'before',
               'after', 'on', 'upon', 'near', 'to', 'is', 'are', 'am']


def count_bad(sentence: str) -> int:
    return 1 if sentence.split(' ')[-1] in BAD_ENDINGS else 0


def oracle_bleu(best_ind: np.ndarray, materials: List[dict]) -> List[float]:
    """Corpus BLEU over per-image oracle-selected ranks (cal_bleu)."""
    testlen = 0
    reflen = 0.0
    guess = [0] * 4
    correct = [0] * 4
    for i in range(best_ind.shape[0]):
        m = materials[best_ind[i]]
        testlen += m["testlen"][i]
        reflen += m["reflen"][i]
        for k in range(4):
            guess[k] += m["guess"][k][i]
            correct[k] += m["correct"][k][i]
    return bleu_from_components(testlen, reflen, guess, correct)


def language_eval(gts_raw: Dict[object, List[str]], align_pred: List[dict],
                  use_spice: bool = True, use_meteor: bool = True,
                  verbose: bool = True, cache_dir: str = None,
                  model_id: str = "model", split: str = "test") -> dict:
    """align_pred: [{'image_id', 'caption': [rank0, rank1, ...]}].

    gts_raw: {image_id: [reference strings]} — the annotation store (the
    reference loads captions_val2014.json / caption_flickr30k.json here).
    Returns the all_scores dict (per-rank per-image score matrices + oracle
    summary) in the reference's layout (sentence_utils.py:72-129).

    If ``cache_dir`` is set, the per-rank prediction dumps are written as
    ``.cache_<model_id>_<split><rank>.json`` — the same inspectable artifact
    the reference leaves in ``eval_results/`` (sentence_utils.py:69-94).
    """
    # only images present in the annotation set (sentence_utils.py:96-99)
    align_pred = [p for p in align_pred if p["image_id"] in gts_raw]
    num_oracle = len(align_pred[0]["caption"])
    image_ids = [p["image_id"] for p in align_pred]
    evaluator = CaptionEvaluator({k: gts_raw[k] for k in image_ids},
                                 image_ids, use_spice, use_meteor)

    metrics = ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L", "CIDEr"]
    if use_meteor:
        metrics.append("METEOR")
    if use_spice:
        metrics.append("SPICE")
    all_scores = {m: np.zeros((num_oracle, len(align_pred))) for m in metrics}
    all_scores["subgraph_bleu_material"] = []
    all_scores["image_id_list"] = image_ids
    top1 = {}

    for rank in range(num_oracle):
        res = {p["image_id"]: p["caption"][rank] for p in align_pred}
        if cache_dir is not None:
            os.makedirs(cache_dir, exist_ok=True)
            cache_path = os.path.join(
                cache_dir, f".cache_{model_id}_{split}{rank}.json")
            with open(cache_path, "w") as f:
                json.dump([{"image_id": i, "caption": c}
                           for i, c in res.items()], f)
        scores = evaluator.evaluate(res)
        if rank == 0:
            top1 = dict(scores)
            if verbose:
                for m in metrics:
                    print(f"{m}: {scores[m]:.4f}")
        for m in metrics:
            all_scores[m][rank, :] = evaluator.eval_scores[m].reshape(-1)
        all_scores["subgraph_bleu_material"].append(
            evaluator.subgraph_training_bleu)

    all_scores["top1"] = top1
    if num_oracle > 1:
        bleu_dict = {}
        for k in range(1, 5):
            m = f"Bleu_{k}"
            best_ind = np.argmax(all_scores[m][:num_oracle], axis=0)
            bleu_dict[m] = oracle_bleu(best_ind,
                                       all_scores["subgraph_bleu_material"])
        all_scores["bleu_dict"] = bleu_dict
        oracle = {f"Bleu_{k}": bleu_dict[f"Bleu_{k}"][k - 1]
                  for k in range(1, 5)}
        for m in metrics:
            if not m.startswith("Bleu"):
                oracle[m] = float(np.mean(np.max(all_scores[m][:num_oracle],
                                                 axis=0)))
        all_scores["oracle"] = oracle
        if verbose:
            for m, v in oracle.items():
                print(f"oracle {m}: {v:.4f}")
    return all_scores


def align_predictions(predictions: List[dict], oracle_num: int) -> List[dict]:
    """Truncate/pad each image's ranked captions to oracle_num
    (eval_utils.py:182-189)."""
    out = []
    for p in predictions:
        caps = list(p["caption"])[:oracle_num]
        while len(caps) < oracle_num:
            caps.append(p["caption"][0])
        out.append({"image_id": p["image_id"], "caption": caps})
    return out
