"""In-memory synthetic training batches, the port's numpy copy of
``subgc_tpu/data/synthetic.py::synthetic_train_batch``: the same draws from
the same ``np.random.RandomState(seed)``, so both packages build identical
batches from one seed.  It needs no label file (and so no h5py), which the
card's machine lacks."""
from __future__ import annotations

import numpy as np

from ..graph import SceneGraph
from ..train.step import TrainBatch


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
