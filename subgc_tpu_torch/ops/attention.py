"""Additive attention: the CUDA kernels, their plain versions, and the
wrappers that choose between them by device.

:func:`shared_attention` (beam-shared) replaces the TPU kernel
``subgc_tpu/ops/pallas_attention.py::_attention_shared_kernel`` (entry
``fused_attention_shared``).  The kernel (``csrc/attention.cu``) takes a
row -> stream index so that one kernel serves both beam layouts of
``models/decoder.py::attention`` (and, at one beam, the greedy fan-out):

* per-sub-graph streams: ``p_att``/``att`` are ``[S, N, *]`` and ``idx`` is
  ``arange(S)``;
* image-shared streams (the default beam path): ``p_att``/``att`` are the
  images' ``[G, n_obj, *]`` streams, ``idx`` is the row -> image map and
  ``mask`` the node-set membership over the image's nodes.

What bounds it on an H100 and what the design does about it is written at
the top of the CUDA source: float32 CUDA-core operations in the ``h @ wh``
projection (bytes in the per-sub-graph layout), and in practice the L2
latency of the ``wh`` reads, which each thread keeps 16 deep in flight.

:func:`row_attention` (one query per row, each row's own streams: the
attention-capture layout of the grounding decode) replaces the TPU kernel
``_attention_kernel`` (entry ``fused_attention``).  It is bound by bytes;
its design is noted beside it in the CUDA source.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel or
raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# kernel launches through :func:`shared_attention` and :func:`row_attention`
# (a test or a run resets them)
LAUNCHES = 0
ROW_LAUNCHES = 0

_FN = None
_ROW_FN = None
_ROW_SPLITS = None


def shared_attention_ref(h, p_att, att, mask, idx, wh, bh, v, bv):
    """Plain PyTorch version of the kernel (same signature and result).

    h [S,B,R], p_att [G,N,H], att [G,N,D], mask [S,N], idx [S] int,
    wh [R,H], bh [H], v [H,1], bv [1] -> (att_res [S,B,D], w [S,B,N]).
    Out-of-range ``idx`` entries clamp, as the JAX gather does.
    """
    g = idx.long().clamp(0, p_att.shape[0] - 1)
    p = p_att[g]                                          # [S, N, H]
    a = att[g]                                            # [S, N, D]
    ah = h @ wh + bh                                      # [S, B, H]
    dot = torch.tanh(p[:, None] + ah[:, :, None, :])      # [S, B, N, H]
    e = (dot @ v)[..., 0] + bv                            # [S, B, N]
    w = torch.softmax(e, dim=-1)
    w = w * mask[:, None, :]
    w = w / w.sum(-1, keepdim=True)
    return w @ a, w


def _kernel():
    global _FN
    if _FN is None:
        fn = _build.load("attention").subgc_shared_attention_f32
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check_args(op, want, device):
    """Raise unless every tensor of ``want`` (name -> (tensor, shape,
    dtype)) has its shape and dtype, lies on ``device`` and is contiguous,
    as the kernel takes it."""
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != device:
            raise ValueError(f"{op}: {name} is on {t.device}, h on {device}")
        if t.dtype != dtype:
            raise TypeError(f"{op}: {name} is {t.dtype}; the kernel takes "
                            f"{dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: the kernel takes contiguous tensors; "
                             f"{name} is not")


def _check(h, p_att, att, mask, idx, wh, bh, v, bv):
    S, B, R = h.shape
    G, N, H = p_att.shape
    D = att.shape[-1]
    f32 = torch.float32
    _check_args("shared_attention", {
        "h": (h, (S, B, R), f32), "p_att": (p_att, (G, N, H), f32),
        "att": (att, (G, N, D), f32), "mask": (mask, (S, N), f32),
        "idx": (idx, (S,), torch.int32), "wh": (wh, (R, H), f32),
        "bh": (bh, (H,), f32), "v": (v, (H, 1), f32), "bv": (bv, (1,), f32),
    }, h.device)
    if not 1 <= B <= 4:
        raise ValueError(f"shared_attention: the kernel takes 1..4 beams, "
                         f"got {B}")
    return S, B, R, G, N, H, D


def shared_attention(h, p_att, att, mask, idx, wh, bh, v, bv):
    """Beam-shared attention; see the module docstring for the layouts.

    On CPU tensors this is :func:`shared_attention_ref`.  On CUDA tensors it
    launches the kernel on the current stream (float32, contiguous,
    ``idx`` int32) and raises on anything the kernel does not take.
    """
    global LAUNCHES
    if h.device.type == "cpu":
        return shared_attention_ref(h, p_att, att, mask, idx, wh, bh, v, bv)
    if h.device.type != "cuda":
        raise ValueError(f"shared_attention: no kernel for {h.device}")
    S, B, R, G, N, H, D = _check(h, p_att, att, mask, idx, wh, bh, v, bv)
    args = (h, p_att, att, mask, idx, wh, bh, v, bv)
    out = torch.empty((S, B, D), dtype=torch.float32, device=h.device)
    w = torch.empty((S, B, N), dtype=torch.float32, device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = _kernel()(*(t.data_ptr() for t in args), out.data_ptr(),
                    w.data_ptr(), S, B, R, G, N, H, D, stream)
    if err != 0:
        raise RuntimeError(f"shared_attention kernel failed: cudaError_t "
                           f"{err}")
    LAUNCHES += 1
    return out, w


def row_attention_ref(h, p_att, att, mask, wh, bh, v, bv):
    """Plain PyTorch version of the per-row kernel (``_attention_kernel``).

    h [R,Hin], p_att [R,N,H], att [R,N,D], mask [R,N], wh [Hin,H], bh [H],
    v [H,1], bv [1] -> (att_res [R,D], w [R,N]).
    """
    ah = h @ wh + bh                                      # [R, H]
    dot = torch.tanh(p_att + ah[:, None, :])              # [R, N, H]
    e = (dot @ v)[..., 0] + bv                            # [R, N]
    w = torch.softmax(e, dim=-1)
    w = w * mask
    w = w / w.sum(-1, keepdim=True)
    return (w[:, None, :] @ att)[:, 0], w


def _row_kernel():
    global _ROW_FN, _ROW_SPLITS
    if _ROW_FN is None:
        lib = _build.load("attention")
        fn = lib.subgc_row_attention_f32
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        splits = lib.subgc_row_attention_splits
        splits.argtypes = [ctypes.c_int] * 3
        splits.restype = ctypes.c_int
        _ROW_FN, _ROW_SPLITS = fn, splits
    return _ROW_FN, _ROW_SPLITS


def _check_rows(h, p_att, att, mask, wh, bh, v, bv):
    if h.dim() != 2 or p_att.dim() != 3 or att.dim() != 3:
        raise ValueError("row_attention: h must be [R, Hin] and the streams "
                         "[R, N, *]")
    R, Hin = h.shape
    N, H = p_att.shape[1:]
    D = att.shape[-1]
    f32 = torch.float32
    _check_args("row_attention", {
        "h": (h, (R, Hin), f32), "p_att": (p_att, (R, N, H), f32),
        "att": (att, (R, N, D), f32), "mask": (mask, (R, N), f32),
        "wh": (wh, (Hin, H), f32), "bh": (bh, (H,), f32),
        "v": (v, (H, 1), f32), "bv": (bv, (1,), f32),
    }, h.device)
    return R, Hin, N, H, D


def row_attention(h, p_att, att, mask, wh, bh, v, bv):
    """Per-row attention (one query per row over the row's own streams).

    On CPU tensors this is :func:`row_attention_ref`.  On CUDA tensors it
    launches the kernel on the current stream (float32, contiguous) and
    raises on anything the kernel does not take.
    """
    global ROW_LAUNCHES
    if h.device.type == "cpu":
        return row_attention_ref(h, p_att, att, mask, wh, bh, v, bv)
    if h.device.type != "cuda":
        raise ValueError(f"row_attention: no kernel for {h.device}")
    R, Hin, N, H, D = _check_rows(h, p_att, att, mask, wh, bh, v, bv)
    args = (h, p_att, att, mask, wh, bh, v, bv)
    fn, splits_fn = _row_kernel()
    splits = splits_fn(R, Hin, H)
    part = torch.empty((splits, R, H), dtype=torch.float32, device=h.device)
    out = torch.empty((R, D), dtype=torch.float32, device=h.device)
    w = torch.empty((R, N), dtype=torch.float32, device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = fn(*(t.data_ptr() for t in args), part.data_ptr(), out.data_ptr(),
             w.data_ptr(), R, Hin, N, H, D, splits, stream)
    if err != 0:
        raise RuntimeError(f"row_attention kernel failed: cudaError_t {err}")
    ROW_LAUNCHES += 1
    return out, w
