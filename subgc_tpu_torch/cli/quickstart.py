"""Hermetic end-to-end walkthrough of every subsystem on synthetic data — the
port's counterpart of ``examples/quickstart.py``:

    python -m subgc_tpu_torch.cli.quickstart [WORKDIR] [--device cpu]

Generates a miniature dataset in the reference's on-disk format, trains the
Sub_GC_Kar preset 10 iterations (``cli/train.py``), decodes the test split
with beam search and scores it with the top-3 oracle (``cli/test.py
--language_eval 1``), prints the diversity report of those captions, and
reranks them by consensus (the NN search on ``--device``).  Everything runs
on ``--device`` (default ``cuda``, which raises without a card; ``cpu``
runs the plain PyTorch path).  The dataset's label file is an npz
(``generate_dataset(..., label_format="npz")``), so the walkthrough needs
no h5py.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("workdir", nargs="?", default=None,
                   help="where the data and the run go (default: a new "
                        "temporary directory)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from ..data.synthetic import generate_dataset
    from ..device import resolve_device
    from ..eval.diversity import diversity_report
    from ..eval.rerank import rerank_predictions
    from . import test as test_cli
    from . import train as train_cli

    dev = resolve_device(args.device)
    workdir = args.workdir or tempfile.mkdtemp()
    print(f"workdir: {workdir}; device {dev}")
    man = generate_dataset(os.path.join(workdir, "data"), n_images=12,
                           seed=1, n_subgraphs=12, label_format="npz")
    common = ["--input_json", man["input_json"],
              "--input_label_h5", man["input_label_h5"],
              "--sg_dir", man["sg_dir"], "--mask_dir", man["mask_dir"],
              "--device", str(dev)]
    ckpt = os.path.join(workdir, "run")

    print("\n--- train (Sub_GC_Kar preset, 10 iterations)")
    train_cli.main(["Sub_GC_Kar", "--checkpoint_path", ckpt,
                    "--batch_size", "4", "--max_iters", "10",
                    "--save_checkpoint_every", "10", "--val_images_use", "4",
                    "--obj_name_path", man["obj_name_path"],
                    "--rel_name_path", man["rel_name_path"]] + common)

    print("\n--- decode + language eval (beam 2, oracle top-3)")
    out = test_cli.main(["Sub_GC_Kar", "--checkpoint_path", ckpt,
                         "--beam_size", "2", "--gpn_max_subg", "8",
                         "--bucket", "32", "--batch_images", "4",
                         "--language_eval", "1", "--oracle_num", "3"]
                        + common)

    caps_path = out["captions_path"]
    preds = np.load(caps_path, allow_pickle=True).tolist()
    print(f"\n--- diversity metrics over {caps_path}")
    report = diversity_report(preds, evaluate_mb4=True)
    print(json.dumps(report, indent=1))

    print("\n--- consensus reranking (synthetic train annos + features)")
    rng = np.random.RandomState(0)
    train_annos = [{"id": i, "sentences": [
        " ".join(rng.choice(list("abcdefgh"), 5))]} for i in range(20)]
    rerank_ind, top1 = rerank_predictions(
        preds, train_annos, rng.rand(20, 16), rng.rand(len(preds), 16),
        {a["id"]: a["sentences"] for a in train_annos}, top_k=3, k=5, m=3,
        num_nn=20, device=dev)
    print(f"reranked {len(rerank_ind)} images; "
          f"example order: {next(iter(rerank_ind.values()))}")

    print("\n--- done; artifacts in", ckpt)
    return {"captions_path": caps_path, "scores": out["scores"],
            "diversity": report, "rerank_ind": rerank_ind, "top1": top1}


if __name__ == "__main__":
    main()
