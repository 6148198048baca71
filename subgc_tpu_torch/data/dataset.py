"""Host-side test loader: enumerates every sampled sub-graph per image.

The test side of ``subgc_tpu/data/dataset.py`` (reference
`dataloaders/dataloader_test.py`), reading the directory-of-npz format.
Produces numpy ``TestExample`` records with fixed shapes.  The training
loader and the packed-shard format are not ported yet.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np

from ..config import DataConfig, ModelConfig
from ..graph import SceneGraph, SubgraphSet, make_scene_graph
from ..io.sg_npz import SGDir
from ..io.vocab import CaptionDataset


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


class ImageInfo(NamedTuple):
    ix: int
    id: int
    file_path: str


class TestExample(NamedTuple):
    graph: SceneGraph          # batch-of-1
    subs: SubgraphSet          # [bucket, ...] flat pos-block/neg-block order
    n_subgraphs: int           # real count before padding
    info: ImageInfo
    gts: np.ndarray            # GT caption rows
    sg_raw: dict               # raw npz dict (boxes etc. for grounding)


class EvalLoader:
    """Enumerates ALL sampled sub-graphs per image (dataloader_test.py:224-230)."""

    def __init__(self, mcfg: ModelConfig, dcfg: DataConfig, bucket: int = 1024):
        if dcfg.packed_path:
            raise NotImplementedError("packed shards are not ported yet")
        self.mcfg = mcfg
        self.dcfg = dcfg
        self.bucket = bucket
        self.ds = CaptionDataset(dcfg.input_json, dcfg.input_label_h5)
        self.sg = SGDir(dcfg.sg_dir)
        self.masks = SGDir(dcfg.mask_dir)
        self.split_ix = self.ds.split_indices(
            dcfg.use_MRNN_split, dcfg.mrnn_split_dict, dcfg.train_only)

    @property
    def vocab(self):
        return self.ds.ix_to_word

    def __len__(self):
        return len(self.split_ix["test"])

    def example(self, pos: int, split: str = "test") -> TestExample:
        ix = self.split_ix[split][pos]
        img = self.ds.images[ix]
        img_id = img["id"]
        m = self.mcfg
        md = self.masks.get(img_id)
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
        mask_info = md["subgraph_mask_list"]
        for s in range(S):
            obj_ind[s], att_mask[s], pred_ind[s] = _left_pack(
                mask_info[5 + s], m.obj_num, m.rel_num)
            valid[s] = True

        sg = self.sg.get(img_id)
        graph = make_scene_graph(sg["object_fmap"], sg["object_dist"],
                                 sg["rel_ind"], sg["pred_dist"],
                                 m.obj_num, m.rel_num)
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
