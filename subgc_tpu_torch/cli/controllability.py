"""Controllability CLI — replaces `misc/controllability/controllability_score.py`.

Consumes ctl_captions_*.npy (from the test CLI with an SCT preset), the GT
group order + grouped GT captions, and a noun-GloVe table, and reports
BLEU/METEOR/ROUGE/CIDEr/SPICE + noun IoU.  The port's counterpart of
``subgc_tpu/cli/controllability.py``: host code, no device.
"""
from __future__ import annotations

import argparse
import pickle

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_file", type=str, required=True)
    p.add_argument("--order_list", type=str, required=True,
                   help="npy list of image ids in GT group order")
    p.add_argument("--gt_captions", type=str, required=True,
                   help="npy list of caption groups aligned with order_list")
    p.add_argument("--noun_glove", type=str, required=True,
                   help="pkl/npz {noun: vector} table "
                        "(flickr_noun_glove.pkl format)")
    args = p.parse_args(argv)

    from ..eval.controllability import NounIoU, controllability_scores

    preds = np.load(args.input_file, allow_pickle=True,
                    encoding="latin1").tolist()
    order = np.load(args.order_list, allow_pickle=True,
                    encoding="latin1").tolist()
    gts = np.load(args.gt_captions, allow_pickle=True,
                  encoding="latin1").tolist()
    if args.noun_glove.endswith((".pkl", ".pickle")):
        with open(args.noun_glove, "rb") as f:
            vectors = pickle.load(f)
    else:
        with np.load(args.noun_glove, allow_pickle=True) as z:
            vectors = {w: v for w, v in zip(z["words"], z["vecs"])}

    out = controllability_scores(preds, order, gts, NounIoU(vectors))
    for k, v in out.items():
        print(f"{k}: {v:.4f}")
    return out


if __name__ == "__main__":
    main()
