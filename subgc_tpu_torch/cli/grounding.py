"""Grounding eval CLI — replaces `misc/grounding/grounding_score.py`.

    python -m subgc_tpu_torch.cli.grounding --reference REF.json \
        --submission grounding_file.json

Consumes the grounding_file.json written by the test CLI (--return_att 1)
plus the Flickr30k Entities reference annotations, and reports precision /
recall / F1 @ IoU 0.5 in 'all' and 'loc' modes.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reference", type=str, required=True,
                   help="flickr30k_cleaned_class.json-style annotations")
    p.add_argument("--submission", type=str, required=True,
                   help="grounding_file.json from the test CLI")
    p.add_argument("--split_file", type=str, default=None)
    p.add_argument("--split", nargs="+", default=["test"])
    p.add_argument("--iou_thresh", type=float, default=0.5)
    args = p.parse_args(argv)

    from ..eval.grounding import FlickrGrdEval

    with open(args.reference) as f:
        blob = json.load(f)
    ref = blob["annotations"] if "annotations" in blob else blob
    if args.split_file:
        with open(args.split_file) as f:
            split_dict = json.load(f)
        keep = set()
        for s in args.split:
            keep.update(str(i) for i in split_dict[s])
        ref = [r for r in ref if str(r["image_id"]) in keep]
    with open(args.submission) as f:
        pred = json.load(f)["results"]

    ev = FlickrGrdEval(ref, pred, iou_thresh=args.iou_thresh)
    out = {}
    for mode in ("all", "loc"):
        res = ev.grd_eval(mode)
        out.update(res)
        print(f"precision_{mode} / recall_{mode} / F1_{mode}: "
              f"{res[f'precision_{mode}']:.4f} / {res[f'recall_{mode}']:.4f} "
              f"/ {res[f'F1_{mode}']:.4f}")
    return out


if __name__ == "__main__":
    main()
