"""Float32 products on the tensor cores at float32 accuracy: the split-TF32
kernels (``csrc/gemm.cu``), their plain versions and the wrapper that
chooses between them by device.

:func:`split_gemm` computes ``x @ w (+ bias)`` for the decoder's step
products (``models/decoder.py::decode_step``).  ``w`` is either the weight
as the model stores it (``[K, N]`` with unit stride along N, rows ``ldb``
apart: a row slice of a contiguous matrix serves as it is), which the call
prepares for itself, or a :class:`SplitWeight` that
:func:`prepare_weight` made once: both TF32 halves of the weight,
``hi = tf32(w)`` and ``lo = tf32(w - hi)``, transposed to K-major.  The
decode prepares each of its seven weights once a call
(``decoder.py::SplitWeights``) and reuses them every step.  It replaces no
TPU kernel: the JAX package leaves these products to XLA, and the port
first left them to ``torch.matmul``, whose float32 product runs on the
H100's CUDA cores.  At the M-RNN decode's shapes (thousands of rows, K =
1,000, N = 4,000 or 9,488) they are bound by operations; the kernel runs
them on the tensor cores in three TF32 passes, ``hi hi + lo hi + hi lo``
summed in float32, the activation split on chip.  What bounds each shape
and how the design answers it is written at the top of the CUDA source.

:func:`split_gemm_ref` and :func:`prepare_weight_ref` repeat the kernels'
arithmetic in plain PyTorch: the same rounding to TF32 (:func:`tf32_round`,
``cvt.rna``), the three products of exactly representable TF32 values
summed in float32.  A CPU tensor goes to them; a CUDA tensor goes to the
kernels or raises.  The kernels are forward-only: asked for a gradient
they raise, so training keeps ``torch.matmul``.  :data:`GEMM_LAUNCHES`
counts the product kernel's launches, :data:`GEMM_WEIGHT_PREPS` the
preparation kernel's.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from ._counts import LaunchCounters

# kernel launches through :func:`run_split_gemm` and :func:`prepare_weight`
# (a test or a run resets them); they change only through COUNTS
# (``_counts.py``), and a replayed CUDA graph adds what its capture counted
GEMM_LAUNCHES = 0
GEMM_WEIGHT_PREPS = 0
COUNTS = LaunchCounters(globals(), ("GEMM_LAUNCHES", "GEMM_WEIGHT_PREPS"))

F32 = torch.float32
_MAP_BYTES = 128        # a CUtensorMap


def reset_launch_counts():
    """Zero :data:`GEMM_LAUNCHES` and :data:`GEMM_WEIGHT_PREPS`."""
    COUNTS.reset()


def count_launch():
    """Add one to :data:`GEMM_LAUNCHES`."""
    COUNTS.add({"GEMM_LAUNCHES": 1})


def count_prep():
    """Add one to :data:`GEMM_WEIGHT_PREPS`."""
    COUNTS.add({"GEMM_WEIGHT_PREPS": 1})


class SplitWeight(NamedTuple):
    """A weight ``w [K, N]`` prepared for the kernel: ``planes [2, N, Kp]``
    holds ``hi = tf32(w).T`` and ``lo = tf32(w - hi).T``, K-major, each row
    zero-padded to ``Kp``, K rounded up to a multiple of 4 (rows of 16
    bytes, as TMA asks); ``tmap`` is the kernel's tensor map of the planes
    (CUDA; None on the CPU).  Holds its planes, so the map stays valid
    while it lives."""
    planes: torch.Tensor
    K: int
    N: int
    tmap: object = None


def tf32_round(x):
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: the kernel's ``cvt.rna.tf32.f32``, on the bits."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(F32)


def _padded(K):
    return -(-K // 4) * 4


def prepare_weight_ref(w):
    """Plain PyTorch version of the preparation kernel: ``w [K, N]`` ->
    :class:`SplitWeight` (no tensor map)."""
    K, N = w.shape
    hi = tf32_round(w)
    lo = tf32_round(w - hi)
    planes = w.new_zeros((2, N, _padded(K)))
    planes[0, :, :K] = hi.T
    planes[1, :, :K] = lo.T
    return SplitWeight(planes, K, N)


def split_gemm_ref(x, w, bias=None):
    """Plain PyTorch version of the kernel: ``x [..., K]``, ``w [K, N]`` or
    its :class:`SplitWeight`, ``bias [N]`` or None -> ``[..., N]`` float32.
    Each operand is split into ``hi = tf32(v)`` and ``lo = tf32(v - hi)``
    (the weight's halves read from its planes, prepared here from a raw
    weight); the products of TF32 values are exact in float32, and
    ``hi hi + (lo hi + hi lo)`` sums them in float32 (the kernel sums each
    32-k slice of the three on the tensor cores and the slices in float32
    registers).  The bias joins after the sum."""
    if not isinstance(w, SplitWeight):
        w = prepare_weight_ref(w)
    K = w.K
    a = x.reshape(x.shape[:-1].numel(), K)
    a_hi = tf32_round(a)
    a_lo = tf32_round(a - a_hi)
    b_hi = w.planes[0, :, :K].T
    b_lo = w.planes[1, :, :K].T
    y = a_hi @ b_hi + (a_lo @ b_hi + a_hi @ b_lo)
    if bias is not None:
        y = y + bias
    return y.reshape(x.shape[:-1] + (w.N,))


_P, _I = ctypes.c_void_p, ctypes.c_int


def _check_weight(w):
    """Raise unless ``w`` is a float32 ``[K, N]`` the kernels take: unit
    stride along N, rows at least N apart."""
    if w.dtype != F32:
        raise TypeError(f"split_gemm: the kernel takes a float32 weight; got "
                        f"{w.dtype} on {w.device}")
    if w.dim() != 2:
        raise ValueError(f"split_gemm: w {tuple(w.shape)} is not [K, N]")
    K, N = w.shape
    if K > 1 and (w.stride(0) < N or (N > 1 and w.stride(1) != 1)):
        raise ValueError("split_gemm: w must be row-major: unit stride along "
                         "N, rows at least N apart")


def _refuse_grad(tensors):
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(
            "split_gemm: the CUDA kernel is forward-only; call it under "
            "torch.no_grad() or on inputs that do not require grad "
            "(training multiplies with torch.matmul)")


def prepare_weight(w):
    """``w [K, N]`` (unit stride along N) -> its :class:`SplitWeight`: on
    CPU tensors :func:`prepare_weight_ref`; on CUDA tensors the
    preparation kernel, on the current stream, and B's tensor map."""
    _check_weight(w)
    if w.device.type == "cpu":
        return prepare_weight_ref(w)
    if w.device.type != "cuda":
        raise ValueError(f"split_gemm: no kernel for {w.device}")
    _refuse_grad((w,))
    K, N = w.shape
    kp = _padded(K)
    planes = torch.empty((2, N, kp), dtype=F32, device=w.device)
    tmap = ctypes.create_string_buffer(_MAP_BYTES)
    fn = _build.entry("gemm", "subgc_split_prep_f32",
                      [_P, _P, _I, _I, _I, _I, _P, _P])
    _build.launch("split_gemm weight preparation", fn, w.device,
                  w.data_ptr(), planes.data_ptr(), K, N,
                  w.stride(0) if K > 1 else N, kp, ctypes.addressof(tmap))
    if K and N:         # else the planes are empty, and nothing launched
        count_prep()
    return SplitWeight(planes, K, N, tmap)


def _check(x, w, bias):
    """Raise unless the call is one the kernel takes; returns (x as
    ``[M, K]`` rows with unit stride, M, N, K).  Cheap on the decode's
    every-step path: each test is one comparison until one fails."""
    prepared = isinstance(w, SplitWeight)
    wt = w.planes if prepared else w
    dev = x.device
    if (x.dtype != F32 or wt.dtype != F32 or wt.device != dev
            or (bias is not None and (bias.dtype != F32
                                      or bias.device != dev))):
        got = ", ".join(f"{n} {t.dtype} on {t.device}" for n, t in
                        (("x", x), ("w", wt), ("bias", bias))
                        if t is not None)
        raise TypeError(f"split_gemm: the kernel takes float32 tensors on "
                        f"one device; got {got}")
    K = x.shape[-1] if x.dim() else -1
    if prepared:
        if w.K != K:
            raise ValueError(f"split_gemm: x {tuple(x.shape)} and a prepared "
                             f"w of K = {w.K} do not meet")
    elif w.dim() != 2 or w.shape[0] != K:
        raise ValueError(f"split_gemm: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not [..., K] and [K, N]")
    else:
        _check_weight(w)
    N = w.N if prepared else w.shape[1]
    if bias is not None and (bias.shape != (N,) or not bias.is_contiguous()):
        raise ValueError(f"split_gemm: bias must be a contiguous [{N}]")
    a = x if x.dim() == 2 else x.reshape(x.shape[:-1].numel(), K)
    if a.shape[0] > 1 and (a.stride(0) < K or (K > 1 and a.stride(1) != 1)):
        a = a.contiguous()
    return a, a.shape[0], N, K


def run_split_gemm(x, w, bias):
    """The kernel on CUDA tensors (``w`` raw or prepared); returns
    ``[..., N]``.  TMA reads A's rows at 16-byte strides from a 16-byte
    aligned start; other rows are first copied into a padded buffer.  At K
    = 0 the kernel reads nothing and writes the bias, or zeros."""
    prepared = isinstance(w, SplitWeight)
    _refuse_grad((x, w.planes if prepared else w, bias))
    a, M, N, K = _check(x, w, bias)
    if not prepared:
        w = prepare_weight(w)
    lda = a.stride(0) if M > 1 else _padded(K)
    if lda % 4 or a.data_ptr() % 16:
        buf = torch.empty((M, _padded(K)), dtype=F32, device=x.device)
        buf[:, :K] = a
        a, lda = buf, buf.stride(0)
    out = torch.empty((M, N), dtype=F32, device=x.device)
    fn = _build.entry("gemm", "subgc_split_gemm_f32",
                      [_P, _I, _P, _P, _P, _I, _I, _I, _P])
    _build.launch("split_gemm kernel", fn, x.device,
                  a.data_ptr(), lda, ctypes.addressof(w.tmap),
                  None if bias is None else bias.data_ptr(), out.data_ptr(),
                  M, N, K)
    if M and N:         # else nothing to write, and nothing launched
        count_launch()
    return out.reshape(x.shape[:-1] + (N,))


def split_gemm(x, w, bias=None):
    """``x @ w (+ bias)`` in float32: ``x [..., K]``, ``w [K, N]`` with
    unit stride along N or its :class:`SplitWeight`, ``bias [N]`` or None
    -> ``[..., N]``.

    On CPU tensors this is :func:`split_gemm_ref`.  On CUDA tensors it
    launches the kernel on the current stream (preparing a raw ``w``
    first) and raises on anything the kernel does not take."""
    if x.device.type == "cpu":
        _check(x, w, bias)
        return split_gemm_ref(x, w, bias)
    if x.device.type != "cuda":
        raise ValueError(f"split_gemm: no kernel for {x.device}")
    return run_split_gemm(x, w, bias)
