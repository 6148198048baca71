"""Float32 products on the tensor cores at float32 accuracy: the split-TF32
kernel (``csrc/gemm.cu``), its plain version and the wrapper that chooses
between them by device.

:func:`split_gemm` computes ``x @ w (+ bias)`` for the decoder's step
products (``models/decoder.py::decode_step``), with the weight as the
model stores it (``[K, N]`` with unit stride along N, rows ``ldb`` apart:
a row slice of a contiguous matrix serves as it is).  It replaces no TPU
kernel: the JAX package leaves these products to XLA, and the port first
left them to ``torch.matmul``, whose float32 product runs on the H100's
CUDA cores.  At the M-RNN decode's shapes (thousands of rows, K = 1,000,
N = 4,000 or 9,488) they are bound by operations; the kernel runs them on
the tensor cores in three TF32 passes, each operand split into
``hi = tf32(x)`` and ``lo = tf32(x - hi)`` on chip (the weight transposed
to K-major there too), summing ``hi hi + lo hi + hi lo`` in float32.
What bounds each shape and how the design answers it is written at the top
of the CUDA source.

:func:`split_gemm_ref` repeats the kernel's arithmetic in plain PyTorch:
the same rounding to TF32 (:func:`tf32_round`, ``cvt.rna``), the three
products of exactly representable TF32 values summed in float32.  A CPU
tensor goes to it; a CUDA tensor goes to the kernel or raises.  The kernel
is forward-only: asked for a gradient it raises, so training keeps
``torch.matmul``.  :data:`GEMM_LAUNCHES` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

# kernel launches through :func:`run_split_gemm` (a test or a run resets
# them); several serving threads launch at once, so changes hold _LOCK
GEMM_LAUNCHES = 0

_FN = []
_LOCK = threading.Lock()
_FN_LOCK = threading.Lock()
F32 = torch.float32


def reset_launch_counts():
    global GEMM_LAUNCHES
    with _LOCK:
        GEMM_LAUNCHES = 0


def count_launch():
    """Add one to :data:`GEMM_LAUNCHES` under the lock."""
    global GEMM_LAUNCHES
    with _LOCK:
        GEMM_LAUNCHES += 1


def tf32_round(x):
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: the kernel's ``cvt.rna.tf32.f32``, on the bits."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(F32)


def split_gemm_ref(x, w, bias=None):
    """Plain PyTorch version of the kernel: ``x [..., K]``, ``w [K, N]``,
    ``bias [N]`` or None -> ``[..., N]`` float32.  Each operand is split into
    ``hi = tf32(v)`` and ``lo = tf32(v - hi)``; the products of TF32 values
    are exact in float32, and ``hi hi + (lo hi + hi lo)`` sums them in
    float32 (the kernel sums each 32-k slice of the three on the tensor
    cores and the slices in float32 registers).  The bias joins after the
    sum."""
    K = x.shape[-1]
    a = x.reshape(-1, K)
    a_hi = tf32_round(a)
    a_lo = tf32_round(a - a_hi)
    b_hi = tf32_round(w)
    b_lo = tf32_round(w - b_hi)
    y = a_hi @ b_hi + (a_lo @ b_hi + a_hi @ b_lo)
    if bias is not None:
        y = y + bias
    return y.reshape(x.shape[:-1] + (w.shape[1],))


def _fn():
    """The ctypes entry of the gemm library, built and loaded on first
    use (once, however many threads ask at the same time)."""
    with _FN_LOCK:
        if not _FN:
            fn = _build.load("gemm").subgc_split_gemm_f32
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _FN.append(fn)
        return _FN[0]


def _check(x, w, bias):
    """Raise unless the call is one the kernel takes; returns (x as
    ``[M, K]`` rows with unit stride, M, N, K).  Cheap on the decode's
    every-step path: each test is one comparison until one fails."""
    dev = x.device
    if (x.dtype != F32 or w.dtype != F32 or w.device != dev
            or (bias is not None and (bias.dtype != F32
                                      or bias.device != dev))):
        got = ", ".join(f"{n} {t.dtype} on {t.device}" for n, t in
                        (("x", x), ("w", w), ("bias", bias))
                        if t is not None)
        raise TypeError(f"split_gemm: the kernel takes float32 tensors on "
                        f"one device; got {got}")
    K = x.shape[-1] if x.dim() else -1
    if w.dim() != 2 or w.shape[0] != K:
        raise ValueError(f"split_gemm: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not [..., K] and [K, N]")
    N = w.shape[1]
    if bias is not None and (bias.shape != (N,) or not bias.is_contiguous()):
        raise ValueError(f"split_gemm: bias must be a contiguous [{N}]")
    if K > 1 and (w.stride(0) < N or (N > 1 and w.stride(1) != 1)):
        raise ValueError("split_gemm: w must be row-major: unit stride along "
                         "N, rows at least N apart")
    a = x if x.dim() == 2 else x.reshape(-1, K)
    if a.shape[0] > 1 and (a.stride(0) < K or (K > 1 and a.stride(1) != 1)):
        a = a.contiguous()
    return a, a.shape[0], N, K


def _refuse_grad(tensors):
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(
            "split_gemm: the CUDA kernel is forward-only; call it under "
            "torch.no_grad() or on inputs that do not require grad "
            "(training multiplies with torch.matmul)")


def run_split_gemm(x, w, bias):
    """The kernel on CUDA tensors; returns ``[..., N]``."""
    _refuse_grad((x, w, bias))
    a, M, N, K = _check(x, w, bias)
    out = torch.empty((M, N), dtype=F32, device=x.device)
    args = (a.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), M, N,
            K, a.stride(0) if M > 1 else K, w.stride(0) if K > 1 else N)
    with torch.cuda.device(x.device):     # the tensors' card and stream
        err = _fn()(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"split_gemm kernel failed: cudaError_t {err}")
    count_launch()
    return out.reshape(x.shape[:-1] + (N,))


def split_gemm(x, w, bias=None):
    """``x @ w (+ bias)`` in float32: ``x [..., K]``, ``w [K, N]`` with
    unit stride along N, ``bias [N]`` or None -> ``[..., N]``.

    On CPU tensors this is :func:`split_gemm_ref`.  On CUDA tensors it
    launches the kernel on the current stream and raises on anything the
    kernel does not take."""
    if x.device.type == "cpu":
        _check(x, w, bias)
        return split_gemm_ref(x, w, bias)
    if x.device.type != "cuda":
        raise ValueError(f"split_gemm: no kernel for {x.device}")
    return run_split_gemm(x, w, bias)
