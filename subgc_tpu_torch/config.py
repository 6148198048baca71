"""Configuration dataclasses, field for field the JAX package's.

The fields, defaults and presets (train and test) are those of
``subgc_tpu/config.py``, so that an ``infos.json`` written by either package
loads in the other (:func:`config_to_json`, :func:`config_from_json`).  Some
fields select code paths that exist only in the JAX package (Pallas
attention, beam chunking, folded or merged LSTM tables); the port reads them
but does not act on them, and says so where a caller would notice.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (the reference's `opts.py:154-189`)."""
    vocab_size: int = 9487              # COCO talk vocab (without +1 for UNK row)
    seq_length: int = 16                # tokens per caption (h5 `labels` width)
    input_encoding_size: int = 1000
    rnn_size: int = 1000
    num_layers: int = 2                 # att-LSTM + lang-LSTM
    att_hid_size: int = 512
    fc_feat_size: int = 2048
    att_feat_size: int = 2048
    drop_prob_lm: float = 0.5
    use_bn: int = 0                     # batchnorm in att_embed (0/1/2)

    # scene-graph encoder
    embed_dim: int = 300                # GloVe dim
    gcn_dim: int = 1024
    gcn_layers: int = 2
    gcn_residual: int = 2
    gcn_bn: bool = False
    noun_fuse: bool = True              # Sub-GC fuses GloVe noun embeddings
    pred_emb_type: int = 1              # 1: argmax excl. background; 2: incl.
    num_obj_classes: int = 1599         # object_dist width
    num_rel_classes: int = 21           # pred_dist width

    # sGPN
    use_gpn: bool = True
    use_gt_subg: bool = False           # Sup. model: skip sGPN scoring
    gpn_hid_dim: int = 512

    # fixed graph shapes (36 detections + 1 dummy node / 64 rels + 1 dummy)
    obj_num: int = 37
    rel_num: int = 65

    # numerics: params stay float32; products may run in bfloat16
    compute_dtype: str = "float32"      # or "bfloat16": the bf16 chain
    bf16_lstm_gates: bool = False       # [S, 4R] gate streams in bf16 too
    bf16_residuals: bool = False        # LSTM backward residuals in bf16
    use_pallas_attention: bool = False  # JAX-only; the port's beam
    #                                     attention always runs its kernel
    fold_embed_ih: bool = False         # JAX-only decode table
    share_att_beams: bool = True        # the port's beam always shares
    share_att_images: bool = True       # beam attends over image streams
    share_att_train: bool = False
    merge_lstm_matmuls: bool = False    # JAX-only decode table

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule (`opts.py` + `train.sh`)."""
    batch_size: int = 64
    seq_per_img: int = 5
    gpn_batch: int = 2
    gpn_label_thres: float = 0.75

    optim: str = "adam"
    learning_rate: float = 5e-4
    optim_alpha: float = 0.9
    optim_beta: float = 0.999
    optim_epsilon: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: float = 10.0
    warmup_n: int = 300
    learning_rate_decay_start: int = 0
    learning_rate_decay_every: int = 3
    learning_rate_decay_rate: float = 0.8

    scheduled_sampling_start: int = 0
    scheduled_sampling_increase_every: int = 5
    scheduled_sampling_increase_prob: float = 0.05
    scheduled_sampling_max_prob: float = 0.25

    max_epochs: int = 35
    save_checkpoint_every: int = 4000
    val_images_use: int = 5000
    losses_log_every: int = 25
    seed: int = 2019

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Decode / eval-time settings (the `test.py:143-167` surface)."""
    beam_size: int = 1
    sample_max: int = 1
    group_size: int = 1
    diversity_lambda: float = 0.5
    decoding_constraint: int = 0
    length_penalty: str = ""            # "", "wu_X", "avg_X"
    gpn_nms_thres: float = 0.75
    gpn_max_subg: int = 1
    max_subgraph_bucket: int = 1024     # padded size of the sub-graph axis
    beam_chunk: int = 1024              # JAX-only decode chunking
    use_topk_sampling: bool = False
    topk_temp: float = 0.6
    the_k: int = 3
    return_att: bool = False
    sct: bool = False
    use_greedy_subg: bool = False
    use_gt_subg: bool = False
    only_sent_eval: int = 0
    oracle_num: int = 1
    num_images: int = -1
    remove_bad_endings: bool = False
    verbose_beam: int = 0

    def replace(self, **kw) -> "EvalConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset paths + split routing (reference `opts.py:7-25,180`)."""
    input_json: str = "data/cocotalk.json"
    input_label_h5: str = "data/cocotalk_label.h5"
    sg_dir: str = ""
    mask_dir: str = ""
    packed_path: str = ""
    obj_name_path: str = "data/object_names_1600-0-20.npy"
    rel_name_path: str = "data/predicate_names_1600-0-20.npy"
    glove_path: str = "data/glove.6B.300d.txt"
    use_MRNN_split: bool = False
    mrnn_split_dict: str = "data/MRNN_split_dict.npy"
    train_only: int = 0
    num_workers: int = 6

    def replace(self, **kw) -> "DataConfig":
        return dataclasses.replace(self, **kw)


_SUB_GC_MODEL = dict(noun_fuse=True, pred_emb_type=1, gcn_layers=2,
                     gcn_residual=2, gcn_bn=False, use_gpn=True)
_FULL_GC_MODEL = dict(noun_fuse=False, pred_emb_type=2, gcn_layers=4,
                      gcn_residual=1, gcn_bn=True, use_gpn=False)
_FLICKR = dict(input_json="data/flickr30ktalk.json",
               input_label_h5="data/flickr30ktalk_label.h5")

TRAIN_PRESETS = {
    # the reference's train.sh presets
    "Sub_GC_MRNN": dict(model=_SUB_GC_MODEL,
                        train=dict(batch_size=64, max_epochs=35),
                        data=dict(use_MRNN_split=True)),
    "Sub_GC_Kar": dict(model=_SUB_GC_MODEL,
                       train=dict(batch_size=64, max_epochs=35),
                       data=dict()),
    "Full_GC_Kar": dict(model=_FULL_GC_MODEL,
                        train=dict(batch_size=100, max_epochs=35,
                                   save_checkpoint_every=3000),
                        data=dict()),
    "Sub_GC_Flickr": dict(model=_SUB_GC_MODEL,
                          train=dict(batch_size=64, max_epochs=36),
                          data=_FLICKR),
    "Sub_GC_Sup_Flickr": dict(model={**_SUB_GC_MODEL, "use_gt_subg": True},
                              train=dict(batch_size=64, max_epochs=36),
                              data=_FLICKR),
}

TEST_PRESETS = {
    # the reference's test.sh presets
    "Sub_GC_MRNN": dict(model=_SUB_GC_MODEL,
                        eval=dict(beam_size=1, gpn_nms_thres=0.55,
                                  gpn_max_subg=1000),
                        data=dict(use_MRNN_split=True)),
    "Sub_GC_S_MRNN": dict(model=_SUB_GC_MODEL,
                          eval=dict(beam_size=1, gpn_nms_thres=0.55,
                                    gpn_max_subg=1000, use_topk_sampling=True,
                                    topk_temp=0.6, the_k=3),
                          data=dict(use_MRNN_split=True)),
    # the paper's headline protocol and this port's main path
    "Sub_GC_Kar": dict(model=_SUB_GC_MODEL,
                       eval=dict(beam_size=2, gpn_nms_thres=0.75,
                                 gpn_max_subg=10),
                       data=dict()),
    "Full_GC_Kar": dict(model=_FULL_GC_MODEL,
                        eval=dict(beam_size=3),
                        data=dict()),
    "Sub_GC_Flickr": dict(model=_SUB_GC_MODEL,
                          eval=dict(beam_size=2, gpn_nms_thres=0.75,
                                    gpn_max_subg=10),
                          data=_FLICKR),
    "Sub_GC_Flickr_GRD": dict(model=_SUB_GC_MODEL,
                              eval=dict(beam_size=1, gpn_nms_thres=0.75,
                                        gpn_max_subg=10, return_att=True),
                              data=_FLICKR),
    "Sub_GC_Flickr_CTL": dict(model=_SUB_GC_MODEL,
                              eval=dict(beam_size=2, gpn_nms_thres=0.75,
                                        gpn_max_subg=10, sct=True,
                                        use_greedy_subg=True),
                              data=_FLICKR),
    "Sub_GC_Sup_Flickr_CTL": dict(model={**_SUB_GC_MODEL, "use_gt_subg": True},
                                  eval=dict(beam_size=2, gpn_nms_thres=0.75,
                                            gpn_max_subg=10, sct=True,
                                            use_gt_subg=True),
                                  data=_FLICKR),
}


def build_configs(model_type: str, mode: str = "test",
                  vocab_size: Optional[int] = None, **overrides):
    """Resolve a MODEL_TYPE preset into (ModelConfig, EvalConfig or, with
    ``mode="train"``, TrainConfig, DataConfig)."""
    registry = TRAIN_PRESETS if mode == "train" else TEST_PRESETS
    if model_type not in registry:
        raise KeyError(f"unknown MODEL_TYPE {model_type!r}; have "
                       f"{sorted(registry)}")
    preset = registry[model_type]
    mkw = dict(preset.get("model", {}))
    if vocab_size is not None:
        mkw["vocab_size"] = vocab_size
    mkw.update(overrides.get("model", {}))
    model = ModelConfig(**mkw)
    data = DataConfig(**{**preset.get("data", {}), **overrides.get("data", {})})
    if mode == "train":
        other = TrainConfig(**{**preset.get("train", {}),
                               **overrides.get("train", {})})
    else:
        other = EvalConfig(**{**preset.get("eval", {}),
                              **overrides.get("eval", {})})
    return model, other, data


def config_to_json(cfg) -> str:
    """A config dataclass as ``infos.json`` stores it."""
    return json.dumps(dataclasses.asdict(cfg), sort_keys=True)


def config_from_json(cls, blob: str):
    """A config dataclass from its JSON (as ``infos.json`` stores it)."""
    return cls(**json.loads(blob))
