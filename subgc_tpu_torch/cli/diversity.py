"""Diversity CLI — `python -m subgc_tpu_torch.cli.diversity --input_file
captions.npy`.

Replaces `misc/diversity/diversity_score.py`: distinct ratio, novel-vs-train
count, 1/2-gram diversity, mBLEU-4 over best-5 of random-20/100.  The
port's counterpart of ``subgc_tpu/cli/diversity.py``: host code, no
device.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_file", type=str, required=True)
    p.add_argument("--train_sentences", type=str, default=None,
                   help="json list (or {img_id: [sents]}) of train captions "
                        "for the novel-caption metric")
    p.add_argument("--evaluate_mB4", action="store_true")
    p.add_argument("--seed", type=int, default=2019)
    args = p.parse_args(argv)

    from ..eval.diversity import diversity_report

    preds = np.load(args.input_file, allow_pickle=True,
                    encoding="latin1").tolist()
    train_sents = []
    if args.train_sentences:
        with open(args.train_sentences) as f:
            blob = json.load(f)
        train_sents = ([s for v in blob.values() for s in v]
                       if isinstance(blob, dict) else blob)
    rep = diversity_report(preds, train_sents,
                           evaluate_mb4=args.evaluate_mB4, seed=args.seed)
    print(json.dumps(rep, indent=1))
    if "distinct" in rep:
        print(f"\nDistinct Caption of random-20: {rep['distinct'][0]:.4f}")
        print(f"Distinct Caption of random-100: {rep['distinct'][1]:.4f}")
    if "mBLEU4" in rep:
        print(f"m-BLEU-4 best-5 of random-20: {rep['mBLEU4'][0]:.4f}")
        print(f"m-BLEU-4 best-5 of random-100: {rep['mBLEU4'][1]:.4f}")
    return rep


if __name__ == "__main__":
    main()
