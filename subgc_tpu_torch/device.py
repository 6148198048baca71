"""Device selection and matmul numerics shared by the port's entry points."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  Raises rather than falling back when no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def pin_matmul_numerics():
    """Set, for the rest of the process, the matmul numerics that
    :func:`f32_accumulation` sets for one call: TF32 off (float32 matmuls
    and convolutions in full float32, as the reference) and bfloat16
    matmuls summing in float32.  A server calls it once, before its first
    dispatch: its threads decode concurrently, and the context manager's
    save-and-restore of these process-global flags would let one thread's
    exit switch them back under another thread's GEMMs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


@contextlib.contextmanager
def f32_accumulation():
    """bfloat16 matmuls on the card sum their products in float32, as the
    JAX package's accumulate (``preferred_element_type`` / XLA's default):
    cuBLAS may otherwise reduce bf16 partial sums in bf16
    (``allow_bf16_reduced_precision_reduction``, on by default).  The flag
    is restored on exit, so it is for one call on one thread at a time
    (a server pins the flags instead: :func:`pin_matmul_numerics`).
    Float32 matmuls are untouched."""
    flags = torch.backends.cuda.matmul
    prev = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        flags.allow_bf16_reduced_precision_reduction = prev
