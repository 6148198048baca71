"""Synthetic data, the port's numpy copy of ``subgc_tpu/data/synthetic.py``:
the same draws from the same ``np.random.RandomState(seed)``, so both
packages build identical data from one seed.

* ``synthetic_train_batch``: an in-memory training batch; it needs no label
  file (and so no h5py, which the card's machine lacks).
* ``generate_dataset``: a miniature dataset in the reference's on-disk
  format (vocab json, label h5, scene-graph and sub-graph-mask npz
  directories, name npys), for the loaders and CLIs; it needs h5py for
  the reference's h5 label file, and none with ``label_format="npz"``.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..graph import SceneGraph
from ..io.sg_npz import write_feat_npz
from ..train.step import TrainBatch

_WORDS = ("man woman dog cat table chair car tree street sky grass ball game "
          "park road water boat bird horse bear pizza food plate glass bottle "
          "light sign window door building person child boy girl shirt hat "
          "standing sitting walking holding riding playing eating looking "
          "wearing near under over behind red blue green small large white "
          "black young old wooden").split()


def synthetic_train_batch(cfg, batch_images: int, seed: int = 0) -> TrainBatch:
    """A production-shaped TrainBatch of random numpy data: 5 sentences per
    image, 2 positive + 2 negative sub-graphs per sentence, labels [S, T+2]
    with BOS/EOS zero slots, 36 detections per image (the real loader's
    contract, data/dataset.py)."""
    rng = np.random.RandomState(seed)
    B, N, K = batch_images, cfg.obj_num, cfg.rel_num
    S, half = B * 5, 2
    graph = SceneGraph(
        obj_fmap=rng.rand(B, N, cfg.att_feat_size).astype(np.float32),
        obj_dist=rng.rand(B, N, cfg.num_obj_classes).astype(np.float32),
        rel_ind=rng.randint(0, N - 1, (B, K, 2)).astype(np.int32),
        pred_dist=rng.rand(B, K, cfg.num_rel_classes).astype(np.float32))
    soi = np.full((S, 2, half, N), N - 1, np.int32)
    sam = np.zeros((S, 2, half, N), np.float32)
    for s in range(S):
        for p in range(2):
            for h in range(half):
                n = rng.randint(3, 9)
                soi[s, p, h, :n] = rng.choice(N - 1, n, replace=False)
                sam[s, p, h, :n] = 1
    labels = np.zeros((S, cfg.seq_length + 2), np.int64)
    labels[:, 1:13] = rng.randint(1, cfg.vocab_size, (S, 12))
    masks = np.zeros((S, cfg.seq_length + 2), np.float32)
    masks[:, :14] = 1
    return TrainBatch(graph=graph, labels=labels.astype(np.int32),
                      masks=masks, sub_obj_ind=soi, sub_att_mask=sam,
                      img_ix=np.repeat(np.arange(B, dtype=np.int32), 5))


def generate_dataset(root: str, n_images: int = 12, vocab_size: int = 60,
                     n_obj_classes: int = 30, n_rel_classes: int = 10,
                     max_obj: int = 36, max_rel: int = 64, n_subgraphs: int = 8,
                     seq_length: int = 16, feat_dim: int = 2048,
                     seed: int = 0, min_obj: int = 6,
                     label_format: str = "h5") -> dict:
    """Write a synthetic dataset under ``root``; returns a path manifest.

    Images route 3:1:1 to train / val / test by index; each has
    ``min_obj``..``max_obj`` detections, 8..``max_rel`` relations, 5 GT
    captions and a bank of 5 GT-noun + ``n_subgraphs`` sampled sub-graphs.
    The JAX generator's ``learnable`` captions are not copied.  The label
    file is the reference's h5 (which needs h5py), or with
    ``label_format="npz"`` the same arrays in an npz that the port's
    loaders read without h5py (the JAX package reads only the h5)."""
    if label_format not in ("h5", "npz"):
        raise ValueError(f"label_format must be 'h5' or 'npz', not "
                         f"{label_format!r}")

    rng = np.random.RandomState(seed)
    sg_dir = os.path.join(root, "sg_output_64")
    mask_dir = os.path.join(root, "graph_mask")
    os.makedirs(sg_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)
    words = (list(_WORDS) + [f"w{i}" for i in range(len(_WORDS), vocab_size)]
             if vocab_size > len(_WORDS) else _WORDS[:vocab_size])
    ix_to_word = {str(i + 1): words[i] for i in range(vocab_size)}

    images, all_labels, start_ix, end_ix = [], [], [], []
    for i in range(n_images):
        img_id = 1000 + i
        split = "val" if i % 5 == 3 else "test" if i % 5 == 4 else "train"
        images.append({"id": int(img_id), "split": split,
                       "file_path": f"synthetic/{img_id}.jpg"})
        n = rng.randint(min_obj, max_obj + 1)
        k = rng.randint(8, max_rel + 1)
        obj_dist = rng.dirichlet(np.ones(n_obj_classes), n).astype("f")
        start_ix.append(len(all_labels) + 1)          # 1-indexed
        for _ in range(5):
            row = np.zeros(seq_length, np.int64)
            ln = rng.randint(5, seq_length)
            row[:ln] = rng.randint(1, vocab_size + 1, ln)
            all_labels.append(row)
        end_ix.append(len(all_labels))
        pred_dist = rng.dirichlet(np.ones(n_rel_classes), k).astype("f")
        rel_ind = rng.randint(0, n, (k, 2)).astype(np.int64)
        boxes = np.abs(rng.rand(n, 4)).astype("f") * 296
        boxes[:, 2:] += boxes[:, :2]
        write_feat_npz(os.path.join(sg_dir, f"{img_id}.npz"), {
            "object_fmap": rng.rand(n, feat_dim).astype("f"),
            "object_dist": obj_dist, "pred_dist": pred_dist,
            "rel_ind": rel_ind, "boxes": boxes})

        total = 5 + n_subgraphs
        mask_list = []
        for _ in range(total):
            sz = rng.randint(2, max(3, n // 2) + 1)
            nodes = rng.choice(n, sz, replace=False)
            obj_mask = np.zeros(max_obj, np.int64)
            obj_mask[nodes] = 1
            in_sub = (np.isin(rel_ind[:, 0], nodes)
                      & np.isin(rel_ind[:, 1], nodes))
            pred_mask = np.zeros(max_rel, np.int64)
            pred_mask[:k][in_sub] = 1
            # re-indexed rel_ind within the sub-graph node ordering
            remap = {int(v): j for j, v in enumerate(np.sort(nodes))}
            nrel = np.array([[remap[int(a)], remap[int(b)]]
                             for a, b in rel_ind[in_sub]],
                            np.int64).reshape(-1, 2)
            mask_list.append([None, obj_mask, pred_mask, nrel,
                              nodes[:max(1, sz // 2)]])
        node_iou = rng.rand(5, total).astype("f")
        node_iou[:, :5] = np.eye(5) * 0.3 + 0.7   # GT columns high-ish
        write_feat_npz(os.path.join(mask_dir, f"{img_id}.npz"), {
            "node_iou_mtx": node_iou, "subgraph_mask_list": mask_list})

    input_json = os.path.join(root, "talk.json")
    with open(input_json, "w") as f:
        json.dump({"ix_to_word": ix_to_word, "images": images}, f)
    label_arrays = {"labels": np.stack(all_labels),
                    "label_start_ix": np.asarray(start_ix, np.int64),
                    "label_end_ix": np.asarray(end_ix, np.int64)}
    if label_format == "npz":
        input_h5 = os.path.join(root, "talk_label.npz")
        np.savez(input_h5, **label_arrays)
    else:
        import h5py

        input_h5 = os.path.join(root, "talk_label.h5")
        with h5py.File(input_h5, "w") as h5:
            for k, v in label_arrays.items():
                h5[k] = v
    obj_name_path = os.path.join(root, "object_names.npy")
    rel_name_path = os.path.join(root, "predicate_names.npy")
    np.save(obj_name_path, np.array(
        ["background"] + [f"class{i}" for i in range(1, n_obj_classes)]))
    np.save(rel_name_path, np.array(
        ["background"] + [f"rel{i}" for i in range(1, n_rel_classes)]))
    return {"root": root, "input_json": input_json, "input_label_h5": input_h5,
            "sg_dir": sg_dir, "mask_dir": mask_dir,
            "obj_name_path": obj_name_path, "rel_name_path": rel_name_path,
            "n_obj_classes": n_obj_classes, "n_rel_classes": n_rel_classes,
            "vocab_size": vocab_size, "seq_length": seq_length,
            "feat_dim": feat_dim}
