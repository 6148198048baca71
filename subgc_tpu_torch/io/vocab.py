"""Vocab json + caption-label h5 readers (dataloaders/dataloader.py:66-98)."""
from __future__ import annotations

import json
from typing import Dict, List

import numpy as np


class CaptionDataset:
    """In-memory view of cocotalk.json + cocotalk_label.h5.

    ``h5py`` is imported only here, when an h5 label file is read: the
    port's other paths run where it is not installed.  A label file named
    ``*.npz`` holding the same three arrays (``labels``,
    ``label_start_ix``, ``label_end_ix``) is read with numpy instead, so a
    dataset runs where h5py is missing (``data/synthetic.py``'s
    ``generate_dataset(..., label_format="npz")`` writes one)."""

    def __init__(self, input_json: str, input_label_h5: str):
        with open(input_json) as f:
            self.info = json.load(f)
        self.ix_to_word: Dict[str, str] = self.info["ix_to_word"]
        self.vocab_size = len(self.ix_to_word)
        self.images: List[dict] = self.info["images"]

        names = ("labels", "label_start_ix", "label_end_ix")
        if input_label_h5.endswith(".npz"):
            with np.load(input_label_h5, allow_pickle=False) as z:
                arrays = [z[k] for k in names]
        else:
            import h5py

            with h5py.File(input_label_h5, "r") as h5:
                arrays = [h5[k][:] for k in names]
        self.labels, self.label_start_ix, self.label_end_ix = arrays
        self.seq_length = self.labels.shape[1]
        self.num_images = self.label_start_ix.shape[0]

    def split_indices(self, use_mrnn_split: bool = False,
                      mrnn_split_dict_path: str = None,
                      train_only: int = 0) -> Dict[str, List[int]]:
        """Karpathy (json 'split') or M-RNN dict routing
        (dataloader.py:103-126); restval joins train unless train_only."""
        split_ix = {"train": [], "val": [], "test": []}
        mrnn = None
        if use_mrnn_split:
            mrnn = np.load(mrnn_split_dict_path, allow_pickle=True,
                           encoding="latin1").tolist()
        for ix, img in enumerate(self.images):
            split = mrnn[img["id"]] if mrnn is not None else img["split"]
            if split in split_ix:
                split_ix[split].append(ix)
            elif train_only == 0:       # restval
                split_ix["train"].append(ix)
        return split_ix

    def captions_for(self, ix: int) -> np.ndarray:
        """All GT caption rows of image ix (1-indexed pointers)."""
        i1 = self.label_start_ix[ix] - 1
        i2 = self.label_end_ix[ix]
        return self.labels[i1:i2]

    def sample_captions(self, ix: int, seq_per_img: int,
                        rng: np.random.RandomState) -> np.ndarray:
        """First seq_per_img captions, resampling w/ replacement if short
        (dataloader.py:149-165)."""
        caps = self.captions_for(ix)
        if caps.shape[0] >= seq_per_img:
            return caps[:seq_per_img]
        idx = rng.randint(0, caps.shape[0], seq_per_img)
        return caps[idx]
