"""Beam-shared additive attention: the CUDA kernel, its plain version, and
the wrapper that chooses between them by device.

Replaces the TPU kernel ``subgc_tpu/ops/pallas_attention.py::
_attention_shared_kernel`` (entry ``fused_attention_shared``).  The kernel
(``csrc/attention.cu``) takes a row -> stream index so that one kernel serves
both beam layouts of ``models/decoder.py::attention``:

* per-sub-graph streams: ``p_att``/``att`` are ``[S, N, *]`` and ``idx`` is
  ``arange(S)``;
* image-shared streams (the default beam path): ``p_att``/``att`` are the
  images' ``[G, n_obj, *]`` streams, ``idx`` is the row -> image map and
  ``mask`` the node-set membership over the image's nodes.

What bounds it on an H100 and what the design does about it is written at
the top of the CUDA source: float32 CUDA-core operations in the ``h @ wh``
projection (bytes in the per-sub-graph layout), and in practice the L2
latency of the ``wh`` reads, which each thread keeps 16 deep in flight.

A CPU tensor goes to :func:`shared_attention_ref`; a CUDA tensor goes to the
kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# kernel launches through :func:`shared_attention` (a test or a run resets it)
LAUNCHES = 0

_FN = None


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


def _check(h, p_att, att, mask, idx, wh, bh, v, bv):
    S, B, R = h.shape
    G, N, H = p_att.shape
    D = att.shape[-1]
    want = {"h": (h, (S, B, R)), "p_att": (p_att, (G, N, H)),
            "att": (att, (G, N, D)), "mask": (mask, (S, N)),
            "idx": (idx, (S,)), "wh": (wh, (R, H)), "bh": (bh, (H,)),
            "v": (v, (H, 1)), "bv": (bv, (1,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"shared_attention: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.device != h.device:
            raise ValueError(f"shared_attention: {name} is on {t.device}, "
                             f"h on {h.device}")
        if name != "idx" and t.dtype != torch.float32:
            raise TypeError(f"shared_attention: {name} is {t.dtype}; the "
                            f"kernel takes float32")
    if idx.dtype != torch.int32:
        raise TypeError(f"shared_attention: idx is {idx.dtype}; the kernel "
                        f"takes int32")
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
    for t in args:
        if not t.is_contiguous():
            raise ValueError("shared_attention: the kernel takes contiguous "
                             "tensors")
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
