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
projection ``h @ wh`` (float32 on the CUDA cores, bfloat16 on the tensor
cores with float32 sums; split over k where the tiles alone would not fill
the card, into a ``[splits, Q, H]`` scratch), then the attention kernel,
which adds the partials and ``bh``.  What bounds each and what the design
does about it is written at the top of the CUDA source.  The tile plan
(:func:`project_plan`, :func:`project_plan_bf16`, :func:`attention_plan`)
is chosen here, so that the CPU tests can check it.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel or
raises.  Each launcher makes the tensors' card current around its launch
(and the shared-memory attribute the CUDA entry sets with it): the entry
launches on the calling thread's current device, which need not be the
card the tensors lie on (a thread serving ``cuda:1`` whose current device
is ``cuda:0``).  The kernels are forward-only, as the Pallas kernels are: asked for
a gradient (grad mode on and an input that requires grad) they raise rather
than return outputs that autograd cannot see through.  Training attends
through ``models/decoder.py::attention_teacher`` instead.

Two storage dtypes, as the Pallas kernels are generic over theirs.  Either
every stream (``h``, ``p_att``, ``att``, ``wh``, ``v``) is float32, or every
stream is bfloat16; ``bh``, ``bv`` and ``mask`` are float32 in both.  Any
other mix raises, on the CPU as on the card.  In bfloat16 each op rounds
where its TPU kernel rounds (the ``compute_dtype="bfloat16"`` chain):

================  ======================  =================  ==================
stage             shared kernel, bf16     row kernel, bf16   attention_teacher
                  (Pallas ``_attention_   (Pallas            (XLA ``decoder.
                  shared_kernel``)        ``_attention_      attention``,
                                          kernel``)          source semantics)
================  ======================  =================  ==================
``ah = h wh``     f32 sums, ``+ bh``,     f32 sums,          product rounded,
                  ONE rounding            ``+ bh``, f32      ``+ bh``, rounded
``p + ah``, tanh  bf16, each rounded      f32 (p upcast)     bf16, each rounded
``e = dot v+bv``  f32 sums, not rounded   f32                product rounded,
                                                             ``+ bv`` f32
softmax, renorm   f32                     f32                f32
weighted sum      ``w`` rounded, f32      ``w`` f32, att     ``w`` rounded,
                  sums                    upcast             f32 sums
outputs           ``att_res`` f32 (its    both f32           f32
                  consumer rounds it,
                  as Pallas does), w f32
================  ======================  =================  ==================

:func:`attention_project` in bfloat16 returns the float32 projection (f32
accumulation of the bf16 products, ``+ bh``), unrounded.  The bfloat16
launches count in :data:`SHARED_BF16_LAUNCHES` and
:data:`ROW_BF16_LAUNCHES`; :data:`PROJECT_LAUNCHES` counts every projection.
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from . import _build
from ._counts import LaunchCounters

# kernel launches through the wrappers (a test or a run resets them):
# shared_attention and row_attention in float32 and in bfloat16, and the
# projection kernel, which every one of the three wrappers launches.  They
# change only through COUNTS (``_counts.py``: under a lock, as a server
# launches from several threads at once); a replayed CUDA graph adds the
# launches its capture counted, so they count kernel runs on every path.
# The first lookup of a kernel entry in _FNS holds _FN_LOCK
LAUNCHES = 0
ROW_LAUNCHES = 0
SHARED_BF16_LAUNCHES = 0
ROW_BF16_LAUNCHES = 0
PROJECT_LAUNCHES = 0
COUNTS = LaunchCounters(globals(), (
    "LAUNCHES", "ROW_LAUNCHES", "SHARED_BF16_LAUNCHES", "ROW_BF16_LAUNCHES",
    "PROJECT_LAUNCHES"))

SMS = 132               # streaming multiprocessors of an H100 SXM
K_SLICE = 16            # k per ring slice of the projection (kBK)
TILE_ROWS = (32, 64, 128)
TILE_COLS = (64, 128)
MAX_QUERIES_PER_BLOCK = 16
MAX_SPLITS = 8
MIN_SLICES_PER_SPLIT = 4
# the bf16 projection on the tensor cores (project_tc_kernel)
K_SLICE_BF16 = 32       # k per ring slice (kBKt): two mma k-steps of 16
TILE_ROWS_BF16 = (16, 32, 64, 128)
MAX_SPLITS_BF16 = 16

_FNS = {}
_FN_LOCK = threading.Lock()
F32, BF16 = torch.float32, torch.bfloat16


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


def project_plan_bf16(Q, Hin, H, bm=None, bn=64, splits=None):
    """Tiles and k split of the bf16 tensor-core projection for Q queries.

    Tiles of ``bm`` queries (a multiple of the mma's 16 rows: 16 up to 16
    queries, 32 up to 256, 64 up to 1024, else 128) x ``bn`` columns; k in
    whole slices of :data:`K_SLICE_BF16` (a multiple of 16), split until
    there are ~2 blocks per SM (at most :data:`MAX_SPLITS_BF16` splits, at
    least one slice each), so that Q = 3 fills the card as Q = 2000 does.
    ``bm``, ``bn`` and ``splits`` override the choice; the split count is
    trimmed so that no split is empty.  Raises ValueError on a shape or a
    tile the kernel does not take.
    """
    if min(Q, Hin, H) < 1:
        raise ValueError(f"project_plan_bf16: Q={Q}, Hin={Hin}, H={H} must "
                         f"be positive")
    if bn not in TILE_COLS:
        raise ValueError(f"project_plan_bf16: bn={bn} not in {TILE_COLS}")
    if bm is None:
        bm = (16 if Q <= 16 else 32 if Q <= 256 else 64 if Q <= 1024
              else 128)
    if bm not in TILE_ROWS_BF16:
        raise ValueError(f"project_plan_bf16: bm={bm} not in "
                         f"{TILE_ROWS_BF16}")
    slices = _cdiv(Hin, K_SLICE_BF16)
    if splits is None:
        tiles = _cdiv(Q, bm) * _cdiv(H, bn)
        splits = max(1, min(2 * SMS // tiles, MAX_SPLITS_BF16))
    elif splits < 1:
        raise ValueError(f"project_plan_bf16: splits={splits} < 1")
    splits = min(splits, slices)
    kchunk = _cdiv(slices, splits) * K_SLICE_BF16
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


def attention_plan(S, B, G, Hin, H, bf16=False, **project):
    """The whole launch plan of :func:`shared_attention` (``G = S`` with
    one beam for :func:`row_attention`); ``bf16``: the bfloat16 entries'
    projection plan (:func:`project_plan_bf16`)."""
    plan = project_plan_bf16 if bf16 else project_plan
    return plan(S * B, Hin, H, **project)._replace(
        rows_per_block=rows_per_block(S, B, G))


def project_scratch(plan, Q, H, device):
    """The ``[splits, Q, H]`` float32 scratch of split partial sums."""
    return torch.empty((plan.splits, Q, H), dtype=torch.float32,
                       device=device)


def reset_launch_counts():
    """Set every launch counter of this module to 0."""
    COUNTS.reset()


def count_launch(counter=None):
    """Add one to :data:`PROJECT_LAUNCHES` (every wrapper launches the
    projection) and to the launch counter named ``counter``, if any."""
    COUNTS.add({"PROJECT_LAUNCHES": 1} if counter is None
               else {counter: 1, "PROJECT_LAUNCHES": 1})


def _fn(name, n_ptr, n_int):
    """The ctypes entry ``name`` of the attention library, built and loaded
    on first use (once, however many threads ask at the same time)."""
    with _FN_LOCK:
        if name not in _FNS:
            fn = getattr(_build.load("attention"), name)
            fn.argtypes = ([ctypes.c_void_p] * n_ptr
                           + [ctypes.c_int] * n_int + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _FNS[name] = fn
        return _FNS[name]


def storage_dtype(op, streams, f32s):
    """The storage dtype of a call: every tensor of ``streams`` (name ->
    tensor) float32, or every one bfloat16, and every tensor of ``f32s``
    float32.  Raises TypeError on any other mix (the table above)."""
    dts = {t.dtype for t in streams.values()}
    if len(dts) != 1 or not dts <= {F32, BF16}:
        raise TypeError(
            f"{op}: {', '.join(streams)} must be all float32 or all "
            f"bfloat16; got " + ", ".join(f"{k} {t.dtype}"
                                          for k, t in streams.items()))
    for name, t in f32s.items():
        if t.dtype != F32:
            raise TypeError(f"{op}: {name} is {t.dtype}; it stays float32 in "
                            f"either storage dtype")
    return dts.pop()


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


def _refuse_grad(op, tensors):
    """Raise if autograd would need a gradient through the kernel: its
    outputs come from raw pointers and carry no ``grad_fn``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{op}: the CUDA kernels are forward-only, as the Pallas kernels "
            f"are; call it under torch.no_grad() or on inputs that do not "
            f"require grad (training attends through "
            f"models.decoder.attention_teacher)")


def _raise_on(op, err):
    if err != 0:
        raise RuntimeError(f"{op} kernel failed: cudaError_t {err}")


def _suffix(dt):
    return "bf16" if dt == BF16 else "f32"


# ---- the projection stage

def attention_project_ref(h, wh, bh):
    """Plain PyTorch version of the projection: h [Q,Hin] @ wh [Hin,H] + bh
    in float32 (bfloat16 h and wh: their exact products summed in
    float32)."""
    if h.dtype == BF16:
        return h.float() @ wh.float() + bh
    return h @ wh + bh


def _project_dtype(h, wh, bh):
    return storage_dtype("attention_project", {"h": h, "wh": wh},
                         {"bh": bh})


def _check_project(h, wh, bh):
    if h.dim() != 2:
        raise ValueError("attention_project: h must be [Q, Hin]")
    Q, Hin = h.shape
    H = wh.shape[-1]
    dt = _project_dtype(h, wh, bh)
    _check_args("attention_project", {
        "h": (h, (Q, Hin), dt), "wh": (wh, (Hin, H), dt),
        "bh": (bh, (H,), F32)}, h.device)
    return Q, Hin, H


def run_attention_project(h, wh, bh, plan):
    """The projection kernel and its split sum on CUDA tensors, at ``plan``."""
    _refuse_grad("attention_project", (h, wh, bh))
    Q, Hin, H = _check_project(h, wh, bh)
    part = project_scratch(plan, Q, H, h.device)
    ah = torch.empty((Q, H), dtype=F32, device=h.device)
    fn = _fn(f"subgc_attention_project_{_suffix(h.dtype)}", 5, 6)
    with torch.cuda.device(h.device):     # the tensors' card (docstring)
        stream = torch.cuda.current_stream(h.device).cuda_stream
        _raise_on("attention_project",
                  fn(h.data_ptr(), wh.data_ptr(), bh.data_ptr(),
                     part.data_ptr(), ah.data_ptr(), Q, Hin, H, plan.bm,
                     plan.bn, plan.splits, stream))
    count_launch()
    return ah


def attention_project(h, wh, bh):
    """``h @ wh + bh`` for every query: :func:`attention_project_ref` on CPU
    tensors, the projection kernel (then its split sum) on CUDA tensors."""
    if h.device.type == "cpu":
        _project_dtype(h, wh, bh)
        return attention_project_ref(h, wh, bh)
    _device_check("attention_project", h)
    Q, Hin, H = _check_project(h, wh, bh)
    plan = project_plan_bf16 if h.dtype == BF16 else project_plan
    return run_attention_project(h, wh, bh, plan(Q, Hin, H))


# ---- beam-shared attention

def shared_attention_ref(h, p_att, att, mask, idx, wh, bh, v, bv):
    """Plain PyTorch version of the kernels (same signature and result).

    h [S,B,R], p_att [G,N,H], att [G,N,D], mask [S,N], idx [S] int,
    wh [R,H], bh [H], v [H,1], bv [1] -> (att_res [S,B,D], w [S,B,N]),
    float32.  Out-of-range ``idx`` entries clamp, as the JAX gather does.
    Bfloat16 streams round as ``_attention_shared_kernel`` does (the table
    above).
    """
    g = idx.long().clamp(0, p_att.shape[0] - 1)
    p = p_att[g]                                          # [S, N, H]
    a = att[g]                                            # [S, N, D]
    if p_att.dtype == BF16:
        ah = (h.float() @ wh.float() + bh).to(BF16)       # one rounding
        dot = torch.tanh(p[:, None] + ah[:, :, None, :])  # bf16 add, tanh
        e = (dot.float() @ v.float())[..., 0] + bv        # f32, unrounded
    else:
        ah = h @ wh + bh                                  # [S, B, H]
        dot = torch.tanh(p[:, None] + ah[:, :, None, :])  # [S, B, N, H]
        e = (dot @ v)[..., 0] + bv                        # [S, B, N]
    w = torch.softmax(e, dim=-1)
    w = w * mask[:, None, :]
    w = w / w.sum(-1, keepdim=True)
    if p_att.dtype == BF16:
        return w.to(BF16).float() @ a.float(), w
    return w @ a, w


def _shared_dtype(h, p_att, att, mask, idx, wh, bh, v, bv):
    return storage_dtype(
        "shared_attention", {"h": h, "p_att": p_att, "att": att, "wh": wh,
                             "v": v}, {"bh": bh, "bv": bv, "mask": mask})


def _check(h, p_att, att, mask, idx, wh, bh, v, bv):
    S, B, R = h.shape
    G, N, H = p_att.shape
    D = att.shape[-1]
    dt = _shared_dtype(h, p_att, att, mask, idx, wh, bh, v, bv)
    _check_args("shared_attention", {
        "h": (h, (S, B, R), dt), "p_att": (p_att, (G, N, H), dt),
        "att": (att, (G, N, D), dt), "mask": (mask, (S, N), F32),
        "idx": (idx, (S,), torch.int32), "wh": (wh, (R, H), dt),
        "bh": (bh, (H,), F32), "v": (v, (H, 1), dt), "bv": (bv, (1,), F32),
    }, h.device)
    if not 1 <= B <= 4:
        raise ValueError(f"shared_attention: the kernel takes 1..4 beams, "
                         f"got {B}")
    return S, B, R, G, N, H, D


def run_shared_attention(args, plan):
    """Both kernels of :func:`shared_attention` on CUDA tensors, at
    ``plan``."""
    _refuse_grad("shared_attention", args)
    S, B, R, G, N, H, D = _check(*args)
    if plan.rows_per_block * B > MAX_QUERIES_PER_BLOCK:
        raise ValueError(f"shared_attention: {plan.rows_per_block} rows of "
                         f"{B} beams exceed {MAX_QUERIES_PER_BLOCK} queries "
                         f"per block")
    dev = args[0].device
    bf16 = args[1].dtype == BF16
    part = project_scratch(plan, S * B, H, dev)
    out = torch.empty((S, B, D), dtype=F32, device=dev)
    w = torch.empty((S, B, N), dtype=F32, device=dev)
    fn = _fn(f"subgc_shared_attention_{_suffix(args[1].dtype)}", 12, 11)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on("shared_attention",
                  fn(*(t.data_ptr() for t in args), part.data_ptr(),
                     out.data_ptr(), w.data_ptr(), S, B, R, G, N, H, D,
                     plan.bm, plan.bn, plan.splits, plan.rows_per_block,
                     stream))
    count_launch("SHARED_BF16_LAUNCHES" if bf16 else "LAUNCHES")
    return out, w


def shared_attention(h, p_att, att, mask, idx, wh, bh, v, bv):
    """Beam-shared attention; see the module docstring for the layouts and
    the two storage dtypes.

    On CPU tensors this is :func:`shared_attention_ref`.  On CUDA tensors it
    launches the kernels on the current stream (float32 or bfloat16 streams
    as the table says, contiguous, ``idx`` int32) and raises on anything
    the kernels do not take.
    """
    args = (h, p_att, att, mask, idx, wh, bh, v, bv)
    if h.device.type == "cpu":
        _shared_dtype(*args)
        return shared_attention_ref(*args)
    _device_check("shared_attention", h)
    S, B, R, G, N, H, D = _check(*args)
    return run_shared_attention(args, attention_plan(
        S, B, G, R, H, bf16=p_att.dtype == BF16))


# ---- per-row attention

def row_attention_ref(h, p_att, att, mask, wh, bh, v, bv):
    """Plain PyTorch version of the per-row kernels (``_attention_kernel``).

    h [R,Hin], p_att [R,N,H], att [R,N,D], mask [R,N], wh [Hin,H], bh [H],
    v [H,1], bv [1] -> (att_res [R,D], w [R,N]), float32.  Bfloat16 streams
    are upcast and the whole chain runs in float32, as the Pallas kernel
    promotes them.
    """
    if p_att.dtype == BF16:
        h, p_att, att, wh, v = (t.float() for t in (h, p_att, att, wh, v))
    ah = h @ wh + bh                                      # [R, H]
    dot = torch.tanh(p_att + ah[:, None, :])              # [R, N, H]
    e = (dot @ v)[..., 0] + bv                            # [R, N]
    w = torch.softmax(e, dim=-1)
    w = w * mask
    w = w / w.sum(-1, keepdim=True)
    return (w[:, None, :] @ att)[:, 0], w


def _row_dtype(h, p_att, att, mask, wh, bh, v, bv):
    return storage_dtype(
        "row_attention", {"h": h, "p_att": p_att, "att": att, "wh": wh,
                          "v": v}, {"bh": bh, "bv": bv, "mask": mask})


def _check_rows(h, p_att, att, mask, wh, bh, v, bv):
    if h.dim() != 2 or p_att.dim() != 3 or att.dim() != 3:
        raise ValueError("row_attention: h must be [R, Hin] and the streams "
                         "[R, N, *]")
    R, Hin = h.shape
    N, H = p_att.shape[1:]
    D = att.shape[-1]
    dt = _row_dtype(h, p_att, att, mask, wh, bh, v, bv)
    _check_args("row_attention", {
        "h": (h, (R, Hin), dt), "p_att": (p_att, (R, N, H), dt),
        "att": (att, (R, N, D), dt), "mask": (mask, (R, N), F32),
        "wh": (wh, (Hin, H), dt), "bh": (bh, (H,), F32),
        "v": (v, (H, 1), dt), "bv": (bv, (1,), F32),
    }, h.device)
    return R, Hin, N, H, D


def run_row_attention(args, plan):
    """Both kernels of :func:`row_attention` on CUDA tensors, at ``plan``
    (one row per attention block)."""
    _refuse_grad("row_attention", args)
    R, Hin, N, H, D = _check_rows(*args)
    dev = args[0].device
    bf16 = args[1].dtype == BF16
    part = project_scratch(plan, R, H, dev)
    out = torch.empty((R, D), dtype=F32, device=dev)
    w = torch.empty((R, N), dtype=F32, device=dev)
    fn = _fn(f"subgc_row_attention_{_suffix(args[1].dtype)}", 11, 8)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on("row_attention",
                  fn(*(t.data_ptr() for t in args), part.data_ptr(),
                     out.data_ptr(), w.data_ptr(), R, Hin, N, H, D, plan.bm,
                     plan.bn, plan.splits, stream))
    count_launch("ROW_BF16_LAUNCHES" if bf16 else "ROW_LAUNCHES")
    return out, w


def row_attention(h, p_att, att, mask, wh, bh, v, bv):
    """Per-row attention (one query per row over the row's own streams).

    On CPU tensors this is :func:`row_attention_ref`.  On CUDA tensors it
    launches the kernels on the current stream (float32 or bfloat16 streams
    as the table says, contiguous) and raises on anything the kernels do
    not take.
    """
    args = (h, p_att, att, mask, wh, bh, v, bv)
    if h.device.type == "cpu":
        _row_dtype(*args)
        return row_attention_ref(*args)
    _device_check("row_attention", h)
    R, Hin, N, H, D = _check_rows(*args)
    return run_row_attention(args, attention_plan(
        R, 1, R, Hin, H, bf16=p_att.dtype == BF16))
