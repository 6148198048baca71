"""Host-side datasets: train sampling and test enumeration loaders.

The counterpart of ``subgc_tpu/data/dataset.py`` (reference
`dataloaders/dataloader.py` for training, `dataloader_test.py` for eval),
reading the directory-of-npz format or, with ``DataConfig.packed_path``,
packed shards (``data/packed_adapter.py``).  Produces numpy ``TrainBatch``
and ``TestExample`` records with fixed shapes.

The training loader is the JAX package's, draw for draw: the same shuffles
(``random.Random``), the same numpy stream for the captions and the
positive/negative sub-graph sampler, so the same seed gives the same
batches.  By default it samples with the host library's C++ sampler
(``ops/native.py``, seeded from the loader's numpy stream), as the JAX
loader does; ``native_sampler=False`` or ``SUBGC_NATIVE_SAMPLER=0`` selects
the Python sampler, the plain version, in both packages.

The weighted positive/negative sampler reproduces the reference
(dataloader.py:224-304): positives have node-IoU >= thres with the
sentence's nouns and are drawn by weight (the remainder absorbed into one
random index); short positives pad with the GT-noun sub-graph; negatives
have IoU < thres and exclude columns positive for any sentence.
"""
from __future__ import annotations

import os
import random
from typing import Iterator, NamedTuple

import numpy as np

from ..config import DataConfig, ModelConfig, TrainConfig
from ..graph import SceneGraph, SubgraphSet, make_scene_graph
from ..io.sg_npz import SGDir
from ..io.vocab import CaptionDataset
from ..train.step import TrainBatch


def _left_pack(mask_entry, obj_num, rel_num):
    """mask_list entry -> (obj_ind, att_mask, pred_ind) left-packed rows."""
    obj_ind = np.full(obj_num, obj_num - 1, np.int32)
    att_mask = np.zeros(obj_num, np.float32)
    pred_ind = np.full(rel_num, rel_num - 1, np.int32)
    nz = np.asarray(mask_entry[1]).nonzero()[0]
    obj_ind[:nz.shape[0]] = nz
    att_mask[:nz.shape[0]] = 1
    pz = np.asarray(mask_entry[2]).nonzero()[0]
    pred_ind[:pz.shape[0]] = pz
    return obj_ind, att_mask, pred_ind


def sample_pos_neg(node_iou_mtx: np.ndarray, thres: float, half: int,
                   seq_per_img: int,
                   rng: np.random.RandomState) -> np.ndarray:
    """Pos/neg sub-graph index sampling (dataloader.py:229-266).

    Returns mask_idx [seq_per_img, half, 2] of indices into the full
    subgraph_mask_list (GT sub-graphs occupy the first 5 slots).
    """
    sampled = node_iou_mtx[:, 5:]
    pos_mask = sampled >= thres
    neg_mask = sampled < thres
    # "impure" positives can't be negatives for any sentence
    neg_mask[:, pos_mask.nonzero()[1]] = 0
    weight = pos_mask / (pos_mask.sum(0) + 1e-7)
    n_weight = (weight.T / (weight.sum(1) + 1e-7)).T

    mask_idx = np.full((seq_per_img, half, 2), -1, np.int64)
    for i in range(seq_per_img):
        pos_idx = pos_mask[i].nonzero()[0]
        if pos_idx.shape[0] < half:
            to_pad = half - pos_idx.shape[0]
            mask_idx[i, :to_pad, 0] = i - 5        # GT-noun sub-graph slot
            mask_idx[i, to_pad:, 0] = pos_idx
        else:
            pos_weight = n_weight[i][pos_idx].copy()
            rd = rng.randint(pos_weight.shape[0], size=1)
            pos_weight[rd[0]] = 1.0 - (pos_weight.sum() - pos_weight[rd[0]])
            mask_idx[i, :, 0] = rng.choice(pos_idx, size=half, replace=True,
                                           p=pos_weight)
        neg_idx = neg_mask[i].nonzero()[0]
        if neg_idx.shape[0] < half:
            tmp_neg = (sampled[i] <= thres).nonzero()[0]
            if tmp_neg.shape[0] == 0:
                pool = (sampled[i] <= 1.0).nonzero()[0]
            elif neg_idx.shape[0] == 0:
                pool = tmp_neg
            else:
                pool = neg_idx
            mask_idx[i, :, 1] = rng.choice(pool, size=half, replace=True)
        else:
            mask_idx[i, :, 1] = rng.choice(neg_idx, size=half, replace=False)
    return mask_idx + 5


class ImageInfo(NamedTuple):
    ix: int
    id: int
    file_path: str


class Loader:
    """Shared base: dataset files, split routing, iteration state and the
    numpy stream the training loader draws from."""

    def __init__(self, mcfg: ModelConfig, dcfg: DataConfig,
                 seq_per_img: int = 5, seed: int = 2019):
        self.mcfg = mcfg
        self.dcfg = dcfg
        self.seq_per_img = seq_per_img
        self.ds = CaptionDataset(dcfg.input_json, dcfg.input_label_h5)
        if dcfg.packed_path:
            # mmap'ed fixed-record shard(s) through the C++ reader
            from .packed_adapter import PackedMaskSource, PackedSGSource
            self.sg = PackedSGSource(dcfg.packed_path)
            self.masks = PackedMaskSource(dcfg.packed_path)
        else:
            self.sg = SGDir(dcfg.sg_dir)
            self.masks = SGDir(dcfg.mask_dir)
        self.split_ix = self.ds.split_indices(
            dcfg.use_MRNN_split, dcfg.mrnn_split_dict, dcfg.train_only)
        self.iterators = {k: 0 for k in self.split_ix}
        self.rng = np.random.RandomState(seed)

    @property
    def vocab(self):
        return self.ds.ix_to_word

    @property
    def vocab_size(self):
        return self.ds.vocab_size

    @property
    def seq_length(self):
        return self.ds.seq_length

    def reset_iterator(self, split):
        self.iterators[split] = 0

    def _scene_graph(self, img_id):
        """(padded SceneGraph, raw npz dict) of one image."""
        sg = self.sg.get(img_id)
        return make_scene_graph(sg["object_fmap"], sg["object_dist"],
                                sg["rel_ind"], sg["pred_dist"],
                                self.mcfg.obj_num, self.mcfg.rel_num), sg


class TrainLoader(Loader):
    """Epoch iteration with shuffling + pos/neg sub-graph sampling."""

    def __init__(self, mcfg: ModelConfig, tcfg: TrainConfig, dcfg: DataConfig,
                 seed: int = 2019, native_sampler: bool = True):
        super().__init__(mcfg, dcfg, tcfg.seq_per_img, seed)
        self.tcfg = tcfg
        self.batch_size = tcfg.batch_size
        self.half = tcfg.gpn_batch
        self.thres = tcfg.gpn_label_thres
        self.use_gt_subg = mcfg.use_gt_subg
        self._shuffled = {k: list(v) for k, v in self.split_ix.items()}
        random.Random(seed).shuffle(self._shuffled["train"])
        # the C++ sampler: the Python sampler's branches and weights, its
        # draws from a generator seeded from this loader's numpy stream
        self.native_sampler = (native_sampler
                               and os.environ.get("SUBGC_NATIVE_SAMPLER",
                                                  "1") != "0")

    def _labels_for(self, ix):
        seq_length = self.ds.seq_length
        label = np.zeros((self.seq_per_img, seq_length + 2), np.int32)
        label[:, 1:seq_length + 1] = self.ds.sample_captions(
            ix, self.seq_per_img, self.rng)
        masks = np.zeros_like(label, np.float32)
        nonzeros = (label != 0).sum(1) + 2
        for r, n in enumerate(nonzeros):
            masks[r, :n] = 1
        return label, masks

    def _example(self, ix: int):
        """One image -> (graph arrays, per-sentence sub-graph indices,
        labels)."""
        img_id = self.ds.images[ix]["id"]
        m = self.mcfg
        spi, half = self.seq_per_img, self.half
        fast = getattr(self.masks, "get_fast", None)
        md = fast(img_id) if fast else self.masks.get(img_id)
        if self.use_gt_subg:
            # Sup. model: GT sub-graph i for sentence i in every slot
            # (dataloader.py:305-333)
            mask_idx = np.tile(np.arange(spi)[:, None, None], (1, half, 2))
        else:
            mask_idx = None
            if self.native_sampler:
                from ..ops.native import sample_pos_neg_native
                mask_idx = sample_pos_neg_native(
                    md["node_iou_mtx"], self.thres, half, spi,
                    seed=int(self.rng.randint(1 << 31)))
            if mask_idx is None:
                # not a fallback from a failure: the C++ sampler declines
                # matrices with fewer rows than sentences (and no sampled
                # column or negative pool), and the JAX loader hands those
                # to the Python sampler too
                mask_idx = sample_pos_neg(md["node_iou_mtx"], self.thres,
                                          half, spi, self.rng)
        if fast:
            # shard rows are already left-packed: one gather
            # [spi, half, 2, obj] -> [spi, 2, half, obj]
            sub_obj = np.ascontiguousarray(
                md["sub_obj_ind"][mask_idx].transpose(0, 2, 1, 3)
            ).astype(np.int32, copy=False)
            sub_mask = np.ascontiguousarray(
                md["sub_att_mask"][mask_idx].transpose(0, 2, 1, 3)
            ).astype(np.float32, copy=False)
        else:
            mask_info = md["subgraph_mask_list"]
            sub_obj = np.full((spi, 2, half, m.obj_num), m.obj_num - 1,
                              np.int32)
            sub_mask = np.zeros((spi, 2, half, m.obj_num), np.float32)
            for i in range(spi):
                for k in range(half):
                    for p in range(2):
                        oi, am, _ = _left_pack(mask_info[mask_idx[i, k, p]],
                                               m.obj_num, m.rel_num)
                        sub_obj[i, p, k] = oi
                        sub_mask[i, p, k] = am
        graph, _ = self._scene_graph(img_id)
        label, masks = self._labels_for(ix)
        return graph, sub_obj, sub_mask, label, masks

    def get_batch(self, split: str = "train"):
        """Returns (TrainBatch of numpy arrays, infos, wrapped)."""
        order = self._shuffled[split]
        bs = self.batch_size
        it = self.iterators[split]
        wrapped = False
        # wrap per image so batches are always exactly batch_size (the
        # reference's BlobFetcher does the same, dataloader.py:447-459)
        ixs = []
        while len(ixs) < bs:
            if it >= len(order):
                it = 0
                wrapped = True
                if split == "train":
                    random.Random(int(self.rng.randint(1 << 31))
                                  ).shuffle(order)
            ixs.append(order[it])
            it += 1
        self.iterators[split] = it

        graphs, objs, masks_, labels, lmasks, infos = [], [], [], [], [], []
        for ix in ixs:
            g, so, sm, lb, lm = self._example(ix)
            graphs.append(g)
            objs.append(so)
            masks_.append(sm)
            labels.append(lb)
            lmasks.append(lm)
            img = self.ds.images[ix]
            infos.append(ImageInfo(ix=ix, id=img["id"],
                                   file_path=img["file_path"]))

        B = len(ixs)
        graph = SceneGraph(*[np.concatenate([getattr(g, f) for g in graphs])
                             for f in SceneGraph._fields])
        batch = TrainBatch(
            graph=graph,
            labels=np.concatenate(labels).astype(np.int32),
            masks=np.concatenate(lmasks),
            sub_obj_ind=np.concatenate(objs),
            sub_att_mask=np.concatenate(masks_),
            img_ix=np.repeat(np.arange(B, dtype=np.int32), self.seq_per_img),
        )
        return batch, infos, wrapped


class TestExample(NamedTuple):
    graph: SceneGraph          # batch-of-1
    subs: SubgraphSet          # [bucket, ...] flat pos-block/neg-block order
    n_subgraphs: int           # real count before padding
    info: ImageInfo
    gts: np.ndarray            # GT caption rows
    sg_raw: dict               # raw npz dict (boxes etc. for grounding)


class EvalLoader(Loader):
    """Enumerates ALL sampled sub-graphs per image (dataloader_test.py:224-230).

    ``seed`` is the JAX loaders' argument; the test loader draws nothing."""

    def __init__(self, mcfg: ModelConfig, dcfg: DataConfig, bucket: int = 1024,
                 seed: int = 2019):
        super().__init__(mcfg, dcfg, seq_per_img=5, seed=seed)
        self.bucket = bucket

    def __len__(self):
        return len(self.split_ix["test"])

    def example(self, pos: int, split: str = "test") -> TestExample:
        ix = self.split_ix[split][pos]
        img = self.ds.images[ix]
        img_id = img["id"]
        m = self.mcfg
        fast = getattr(self.masks, "get_fast", None)
        md = fast(img_id) if fast else self.masks.get(img_id)
        total = md["node_iou_mtx"][:, 5:].shape[1]
        # flat order: first-half block then second-half block, skipping the
        # 5 GT slots (dataloader_test.py:226-230) — contiguous 5..5+2M
        S = 2 * (total // 2)
        if S > self.bucket:
            raise ValueError(
                f"image {img_id} has {S} sub-graphs > bucket {self.bucket}; "
                f"pass a larger bucket")
        obj_ind = np.full((self.bucket, m.obj_num), m.obj_num - 1, np.int32)
        att_mask = np.zeros((self.bucket, m.obj_num), np.float32)
        att_mask[:, 0] = 1.0       # padded slots keep the dummy node "live"
        pred_ind = np.full((self.bucket, m.rel_num), m.rel_num - 1, np.int32)
        valid = np.zeros((self.bucket,), bool)
        if fast:
            obj_ind[:S] = md["sub_obj_ind"][5:5 + S]
            att_mask[:S] = md["sub_att_mask"][5:5 + S]
            pred_ind[:S] = md["sub_pred_ind"][5:5 + S]
        else:
            mask_info = md["subgraph_mask_list"]
            for s in range(S):
                obj_ind[s], att_mask[s], pred_ind[s] = _left_pack(
                    mask_info[5 + s], m.obj_num, m.rel_num)
        valid[:S] = True

        graph, sg = self._scene_graph(img_id)
        subs = SubgraphSet(obj_ind=obj_ind, pred_ind=pred_ind,
                           att_mask=att_mask, valid=valid)
        return TestExample(graph=graph, subs=subs, n_subgraphs=S,
                           info=ImageInfo(ix=ix, id=img_id,
                                          file_path=img["file_path"]),
                           gts=self.ds.captions_for(ix), sg_raw=sg)

    def iter_split(self, split: str = "test",
                   num_images: int = -1) -> Iterator[TestExample]:
        n = len(self.split_ix[split])
        if num_images >= 0:
            n = min(n, num_images)
        for pos in range(n):
            yield self.example(pos, split)
