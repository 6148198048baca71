"""subgc_tpu_torch — the PyTorch/CUDA port of subgc_tpu.

Sub-GC scene-graph-decomposition captioning (ECCV 2020) on an NVIDIA H100:
the Sub_GC_Kar test path (encoder -> sGPN scoring -> sub-graph NMS -> beam
search -> ``captions_*.npy``) in PyTorch, with the decoder's beam-shared
attention as a hand-written CUDA kernel (``ops/csrc/attention.cu``).  The
JAX package ``subgc_tpu`` is the reference it is held against; this package
imports neither it nor jax.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``, where every op takes its plain PyTorch version.
"""
__version__ = "0.1.0"

from .config import (DataConfig, EvalConfig, ModelConfig,  # noqa: F401
                     TEST_PRESETS, TrainConfig, build_configs,
                     config_from_json)
from .data.dataset import EvalLoader, ImageInfo, TestExample  # noqa: F401
from .decode.beam import BeamOut, beam_search  # noqa: F401
from .device import resolve_device  # noqa: F401
from .eval.runner import (make_batched_infer_fn, run_test_split,  # noqa: F401
                          save_predictions)
from .graph import (SceneGraph, SubgraphSet, make_scene_graph,  # noqa: F401
                    pad_subgraph_set, subgraphs_from_masks, to_device)
from .models.params import (init_params, load_model_npz,  # noqa: F401
                            params_from_numpy)
from .models.subgc import (EncodedImage, encode_image,  # noqa: F401
                           encode_images_batched)
from .utils.text import decode_sequence  # noqa: F401
