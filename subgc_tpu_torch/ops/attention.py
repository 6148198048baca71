"""Additive attention: the CUDA kernels, their plain versions, the tile plan
and the wrappers that choose between them by device.

:func:`shared_attention` (beam-shared) replaces the TPU kernel
``subgc_tpu/ops/pallas_attention.py::_attention_shared_kernel`` (entry
``fused_attention_shared``).  The kernels (``csrc/attention.cu``) take a
row -> stream index so that they serve both beam layouts of
``models/decoder.py::attention`` (and, at one beam, the greedy fan-out):

* per-sub-graph streams: ``p_att``/``att`` are ``[S, N, *]`` and ``idx`` is
  ``arange(S)``;
* image-shared streams (the default beam path): ``p_att``/``att`` are the
  images' ``[G, n_obj, *]`` streams, ``idx`` is the row -> image map and
  ``mask`` the node-set membership over the image's nodes.

:func:`row_attention` (one query per row, each row's own streams: the
attention-capture layout of the grounding decode) replaces the TPU kernel
``_attention_kernel`` (entry ``fused_attention``): the same two kernels at
one beam with row r reading stream r.

Both wrappers launch two kernels: :func:`attention_project`'s staged
float32 projection ``h @ wh`` (split over k where the tiles alone would not
fill the card, into a ``[splits, Q, H]`` scratch), then the attention kernel,
which adds the partials and ``bh``.  What bounds each and what the design
does about it is written at the top of the CUDA source.  The tile plan
(:func:`project_plan`, :func:`attention_plan`) is chosen here, so that the
CPU tests can check it.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel or
raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

# kernel launches through the wrappers (a test or a run resets them):
# shared_attention, row_attention, and the projection kernel, which every
# one of the three wrappers launches
LAUNCHES = 0
ROW_LAUNCHES = 0
PROJECT_LAUNCHES = 0

SMS = 132               # streaming multiprocessors of an H100 SXM
K_SLICE = 16            # k per ring slice of the projection (kBK)
TILE_ROWS = (32, 64, 128)
TILE_COLS = (64, 128)
MAX_QUERIES_PER_BLOCK = 16
MAX_SPLITS = 8
MIN_SLICES_PER_SPLIT = 4

_FNS = {}


class Plan(NamedTuple):
    """Launch plan: projection tiles of ``bm`` queries x ``bn`` columns,
    k split ``splits`` ways in chunks of ``kchunk`` (whole slices, no empty
    split), and ``rows_per_block`` rows per attention block."""
    bm: int
    bn: int
    splits: int
    kchunk: int
    rows_per_block: int = 1


def _cdiv(a, b):
    return -(-a // b)


def project_plan(Q, Hin, H, bm=None, bn=64, splits=None):
    """Tiles and k split of the projection for Q queries.

    By default (the fastest plans of ``tools/sweep_attention_tiles.py`` on
    an H100): 128-query tiles from 512 queries, else 64 (32 below 256
    queries), 64 columns; then k is split until there are ~2 blocks per SM,
    at least 4 slices of 16 k per split, at most 8 splits.
    ``bm``, ``bn`` and ``splits`` override the choice (the tile sweep); the
    split count is trimmed so that no split is empty.
    """
    if bn not in TILE_COLS:
        raise ValueError(f"project_plan: bn={bn} not in {TILE_COLS}")
    n_cols = _cdiv(H, bn)
    if bm is None:
        bm = 128 if Q >= 512 else 64 if Q >= 256 else 32
    if bm not in TILE_ROWS:
        raise ValueError(f"project_plan: bm={bm} not in {TILE_ROWS}")
    slices = _cdiv(Hin, K_SLICE)
    if splits is None:
        tiles = _cdiv(Q, bm) * n_cols
        splits = min(2 * SMS // tiles, MAX_SPLITS,
                     slices // MIN_SLICES_PER_SPLIT)
    splits = max(1, min(splits, slices))
    kchunk = _cdiv(slices, splits) * K_SLICE
    return Plan(bm, bn, _cdiv(Hin, kchunk), kchunk)


def rows_per_block(S, B, G):
    """Rows per attention block: 1 where rows have streams of their own;
    where several rows share a stream, the most (a power of two, at most
    16 queries, at most a stream's rows) that still give a block per SM."""
    rpb = 1
    while (2 * rpb * B <= MAX_QUERIES_PER_BLOCK and 2 * rpb <= S // G
           and _cdiv(S, 2 * rpb) >= SMS):
        rpb *= 2
    return rpb


def attention_plan(S, B, G, Hin, H, **project):
    """The whole launch plan of :func:`shared_attention` (``G = S`` with
    one beam for :func:`row_attention`)."""
    return project_plan(S * B, Hin, H, **project)._replace(
        rows_per_block=rows_per_block(S, B, G))


def project_scratch(plan, Q, H, device):
    """The ``[splits, Q, H]`` float32 scratch of split partial sums."""
    return torch.empty((plan.splits, Q, H), dtype=torch.float32,
                       device=device)


def _fn(name, n_ptr, n_int):
    if name not in _FNS:
        fn = getattr(_build.load("attention"), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


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


def _device_check(op, h):
    if h.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for {h.device}")


def _raise_on(op, err):
    if err != 0:
        raise RuntimeError(f"{op} kernel failed: cudaError_t {err}")


# ---- the projection stage

def attention_project_ref(h, wh, bh):
    """Plain PyTorch version of the projection: h [Q,Hin] @ wh [Hin,H] + bh."""
    return h @ wh + bh


def _check_project(h, wh, bh):
    if h.dim() != 2:
        raise ValueError("attention_project: h must be [Q, Hin]")
    Q, Hin = h.shape
    H = wh.shape[-1]
    f32 = torch.float32
    _check_args("attention_project", {
        "h": (h, (Q, Hin), f32), "wh": (wh, (Hin, H), f32),
        "bh": (bh, (H,), f32)}, h.device)
    return Q, Hin, H


def run_attention_project(h, wh, bh, plan):
    """The projection kernel and its split sum on CUDA tensors, at ``plan``."""
    global PROJECT_LAUNCHES
    Q, Hin, H = _check_project(h, wh, bh)
    part = project_scratch(plan, Q, H, h.device)
    ah = torch.empty((Q, H), dtype=torch.float32, device=h.device)
    fn = _fn("subgc_attention_project_f32", 5, 6)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    _raise_on("attention_project",
              fn(h.data_ptr(), wh.data_ptr(), bh.data_ptr(), part.data_ptr(),
                 ah.data_ptr(), Q, Hin, H, plan.bm, plan.bn, plan.splits,
                 stream))
    PROJECT_LAUNCHES += 1
    return ah


def attention_project(h, wh, bh):
    """``h @ wh + bh`` for every query: :func:`attention_project_ref` on CPU
    tensors, the projection kernel (then its split sum) on CUDA tensors."""
    if h.device.type == "cpu":
        return attention_project_ref(h, wh, bh)
    _device_check("attention_project", h)
    Q, Hin, H = _check_project(h, wh, bh)
    return run_attention_project(h, wh, bh, project_plan(Q, Hin, H))


# ---- beam-shared attention

def shared_attention_ref(h, p_att, att, mask, idx, wh, bh, v, bv):
    """Plain PyTorch version of the kernels (same signature and result).

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


def run_shared_attention(args, plan):
    """Both kernels of :func:`shared_attention` on CUDA tensors, at
    ``plan``."""
    global LAUNCHES, PROJECT_LAUNCHES
    S, B, R, G, N, H, D = _check(*args)
    if plan.rows_per_block * B > MAX_QUERIES_PER_BLOCK:
        raise ValueError(f"shared_attention: {plan.rows_per_block} rows of "
                         f"{B} beams exceed {MAX_QUERIES_PER_BLOCK} queries "
                         f"per block")
    dev = args[0].device
    part = project_scratch(plan, S * B, H, dev)
    out = torch.empty((S, B, D), dtype=torch.float32, device=dev)
    w = torch.empty((S, B, N), dtype=torch.float32, device=dev)
    fn = _fn("subgc_shared_attention_f32", 12, 11)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on("shared_attention",
              fn(*(t.data_ptr() for t in args), part.data_ptr(),
                 out.data_ptr(), w.data_ptr(), S, B, R, G, N, H, D, plan.bm,
                 plan.bn, plan.splits, plan.rows_per_block, stream))
    LAUNCHES += 1
    PROJECT_LAUNCHES += 1
    return out, w


def shared_attention(h, p_att, att, mask, idx, wh, bh, v, bv):
    """Beam-shared attention; see the module docstring for the layouts.

    On CPU tensors this is :func:`shared_attention_ref`.  On CUDA tensors it
    launches the kernels on the current stream (float32, contiguous,
    ``idx`` int32) and raises on anything the kernels do not take.
    """
    if h.device.type == "cpu":
        return shared_attention_ref(h, p_att, att, mask, idx, wh, bh, v, bv)
    _device_check("shared_attention", h)
    args = (h, p_att, att, mask, idx, wh, bh, v, bv)
    S, B, R, G, N, H, D = _check(*args)
    return run_shared_attention(args, attention_plan(S, B, G, R, H))


# ---- per-row attention

def row_attention_ref(h, p_att, att, mask, wh, bh, v, bv):
    """Plain PyTorch version of the per-row kernels (``_attention_kernel``).

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


def run_row_attention(args, plan):
    """Both kernels of :func:`row_attention` on CUDA tensors, at ``plan``
    (one row per attention block)."""
    global ROW_LAUNCHES, PROJECT_LAUNCHES
    R, Hin, N, H, D = _check_rows(*args)
    dev = args[0].device
    part = project_scratch(plan, R, H, dev)
    out = torch.empty((R, D), dtype=torch.float32, device=dev)
    w = torch.empty((R, N), dtype=torch.float32, device=dev)
    fn = _fn("subgc_row_attention_f32", 11, 8)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on("row_attention",
              fn(*(t.data_ptr() for t in args), part.data_ptr(),
                 out.data_ptr(), w.data_ptr(), R, Hin, N, H, D, plan.bm,
                 plan.bn, plan.splits, stream))
    ROW_LAUNCHES += 1
    PROJECT_LAUNCHES += 1
    return out, w


def row_attention(h, p_att, att, mask, wh, bh, v, bv):
    """Per-row attention (one query per row over the row's own streams).

    On CPU tensors this is :func:`row_attention_ref`.  On CUDA tensors it
    launches the kernels on the current stream (float32, contiguous) and
    raises on anything the kernels do not take.
    """
    if h.device.type == "cpu":
        return row_attention_ref(h, p_att, att, mask, wh, bh, v, bv)
    _device_check("row_attention", h)
    args = (h, p_att, att, mask, wh, bh, v, bv)
    R, Hin, N, H, D = _check_rows(*args)
    return run_row_attention(args, attention_plan(R, 1, R, Hin, H))
