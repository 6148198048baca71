"""Seeded training traffic: a copy of
``subgc_tpu_torch/data/synthetic.py::synthetic_train_batch`` with its
shapes and distributions (five sentences an image, two positive and two
negative sub-graphs of 3 to 8 nodes a sentence, 12-word captions, uniform
features over every node row), drawn with numpy's ``Generator`` in a few
array calls instead of a loop, from a seed of any size."""
from __future__ import annotations

import numpy as np


def train_batch(seed: int, index: int, cfg: dict, batch_images: int,
                seq_per_img: int, half: int):
    """One host batch as a dict of numpy arrays, the fields of the port's
    ``TrainBatch`` (graph fields flat)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed % (1 << 64), index, 3]))
    B, N, K = batch_images, cfg["obj_num"], cfg["rel_num"]
    S = B * seq_per_img
    T = cfg["seq_length"]
    batch = {
        "obj_fmap": rng.random((B, N, cfg["att_feat_size"]), np.float32),
        "obj_dist": rng.random((B, N, cfg["num_obj_classes"]), np.float32),
        "rel_ind": rng.integers(0, N - 1, (B, K, 2)).astype(np.int32),
        "pred_dist": rng.random((B, K, cfg["num_rel_classes"]), np.float32),
    }
    # each sub-graph: 3..8 distinct nodes of the N - 1 real ones
    count = rng.integers(3, 9, (S, 2, half))
    perm = np.argsort(rng.random((S, 2, half, N - 1)), -1)
    live = np.arange(N) < count[..., None]
    first = np.concatenate([perm, np.full(perm.shape[:-1] + (1,), N - 1)], -1)
    soi = np.where(live, first, N - 1).astype(np.int32)
    batch["sub_obj_ind"] = soi
    batch["sub_att_mask"] = live.astype(np.float32)
    labels = np.zeros((S, T + 2), np.int32)
    labels[:, 1:13] = rng.integers(1, cfg["vocab_size"], (S, 12))
    masks = np.zeros((S, T + 2), np.float32)
    masks[:, :14] = 1.0
    batch["labels"] = labels
    batch["masks"] = masks
    batch["img_ix"] = np.repeat(np.arange(B, dtype=np.int32), seq_per_img)
    return batch
