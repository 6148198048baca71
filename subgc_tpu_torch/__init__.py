"""subgc_tpu_torch — the PyTorch/CUDA port of subgc_tpu.

Sub-GC scene-graph-decomposition captioning (ECCV 2020) on an NVIDIA H100:
the test path (encoder -> sGPN scoring -> sub-graph NMS -> decode ->
``captions_*.npy``) in PyTorch, for every test preset: beam search
(Sub_GC_Kar, Sub_GC_Flickr), greedy and top-k sampling over the
image-shared fan-out (Sub_GC_MRNN, Sub_GC_S_MRNN), greedy with attention
capture for Flickr30k-Entities grounding (Sub_GC_Flickr_GRD), the
controllability protocol without NMS (Sub_GC_Flickr_CTL,
Sub_GC_Sup_Flickr_CTL, through ``SCTLoader``), and the Full-GC baseline
with its GCN BatchNorm (Full_GC_Kar, per image through ``encode_image``).
``python -m subgc_tpu_torch.cli.test <MODEL_TYPE>`` decodes a split, and
``python -m subgc_tpu_torch.cli.train <MODEL_TYPE>`` trains any of the five
train presets (``train_forward``, ``train/step.py``, ``TrainLoader``).  The
decoder's additive attention runs as hand-written CUDA kernels
(``ops/csrc/attention.cu``): beam-shared and per-row, forward-only, so
training attends through torch ops under autograd.  The JAX package
``subgc_tpu`` is the reference it is held against; this package imports
neither it nor jax.

``subgc_tpu_torch.setup`` builds a model's (params, state), optionally
from a checkpoint directory, and ``python -m subgc_tpu_torch.cli.convert_ckpt``
writes one from the reference's published ``model-*.pth`` + ``infos_*.pkl``
(``cli/parity_eval.py`` checks its captions; ``cli/pack.py`` packs shards;
``cli/quickstart.py`` walks every subsystem on synthetic data).

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``, where every op takes its plain PyTorch version.
"""
__version__ = "0.1.0"

from .config import (DataConfig, EvalConfig, ModelConfig,  # noqa: F401
                     TEST_PRESETS, TRAIN_PRESETS, TrainConfig,
                     build_configs, config_from_json, config_to_json)
from .data.dataset import (EvalLoader, ImageInfo, TestExample,  # noqa: F401
                           TrainLoader)
from .data.sct import SCTLoader  # noqa: F401
from .decode.beam import BeamOut, beam_search  # noqa: F401
from .decode.greedy import SampleOut, sample  # noqa: F401
from .device import resolve_device  # noqa: F401
from .eval.grounding import FlickrGrdEval, GroundingCollector  # noqa: F401
from .eval.runner import (make_batched_infer_fn, run_test_split,  # noqa: F401
                          save_predictions)
from .graph import (SceneGraph, SubgraphSet, make_scene_graph,  # noqa: F401
                    pad_subgraph_set, subgraphs_from_masks, to_device)
from .models.params import (init_params, load_model_npz,  # noqa: F401
                            params_from_numpy)
from .models.subgc import (EncodedImage, encode_image,  # noqa: F401
                           encode_images_batched, train_forward)
from .utils.text import decode_sequence  # noqa: F401


def __getattr__(name):
    # the model factory, reached as subgc_tpu.setup is in the JAX package
    if name == "setup":
        from .models import setup
        return setup
    raise AttributeError(name)
