"""Consensus reranking CLI — replaces `misc/consensus_reranking/cr_mRNN_demo.py`;
the port's counterpart of ``subgc_tpu/cli/rerank.py``.

Inputs:
* --input_file captions_*.npy (sGPN-ranked captions per test image)
* --train_annos npy/json: [{'id', 'sentences': [str]}] train+val references
* --feats npz with `train` [N_tr, D] and `test` [N_te, D] global image
  features aligned with --train_annos order / the captions file order
Outputs consensus_rerank_ind.npy next to the captions file and evaluates the
reranked top-1 with the framework's scorers when --gts is given.  The
nearest-neighbour image search runs on ``--device`` (default ``cuda``;
``cpu`` runs it in plain PyTorch on the host).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_file", type=str, required=True)
    p.add_argument("--train_annos", type=str, required=True)
    p.add_argument("--feats", type=str, required=True)
    p.add_argument("--gts", type=str, default=None,
                   help="json {image_id: [ref strings]} to score the top-1")
    p.add_argument("--top_k", type=int, default=4)
    p.add_argument("--k", type=int, default=60)
    p.add_argument("--m", type=int, default=125)
    p.add_argument("--num_NN", type=int, default=1000)
    p.add_argument("--device", type=str, default="cuda",
                   help="where the NN search runs: cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..eval.rerank import rerank_predictions
    from ..eval.sentence import language_eval

    preds = np.load(args.input_file, allow_pickle=True,
                    encoding="latin1").tolist()
    if args.train_annos.endswith(".json"):
        with open(args.train_annos) as f:
            train_annos = json.load(f)
    else:
        train_annos = np.load(args.train_annos, allow_pickle=True,
                              encoding="latin1").tolist()
    with np.load(args.feats) as z:
        train_feats, test_feats = z["train"], z["test"]

    df_refs = {a["id"]: a["sentences"] for a in train_annos}
    rerank_ind, top1 = rerank_predictions(
        preds, train_annos, train_feats, test_feats, df_refs,
        top_k=args.top_k, k=args.k, m=args.m, num_nn=args.num_NN,
        device=args.device)

    out_path = os.path.join(os.path.dirname(args.input_file),
                            "consensus_rerank_ind.npy")
    np.save(out_path, np.asarray(rerank_ind, dtype=object),
            allow_pickle=True)
    print(f"wrote {out_path}")

    scores = None
    if args.gts:
        with open(args.gts) as f:
            gts = {int(k): v for k, v in json.load(f).items()}
        aligned = [{"image_id": i, "caption": [c]} for i, c in top1.items()]
        scores = language_eval(gts, aligned)
    return {"rerank_ind_path": out_path, "scores": scores}


if __name__ == "__main__":
    main()
