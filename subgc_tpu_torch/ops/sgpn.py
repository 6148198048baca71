"""The sGPN test path's two kernels (``csrc/sgpn.cu``) and their launchers.

* :func:`readout_max`: the max half of the sub-graph read-out
  (``models/gpn.py::gpn_test_forward``): for each sub-graph, the max over
  the image's node rows of ``x + (member ? 0 : -1e30)``, the torch path's
  masked broadcast term by term, without its ``[B, S, n_obj, L]``
  intermediate.
* :func:`nms_keep_sorted`: the keep set of greedy sub-graph NMS
  (``models/gpn.py::subgraph_nms``), in score order, at most ``max_keep``
  an image: one launch, a block an image, with no host round trip.

Neither replaces a TPU kernel: the JAX package leaves both to XLA.  Both
read a sub-graph's node set from its node list (``obj_ind``, ``att_mask``
``[..., S, N]``) as one 64-bit word, so an image has at most
:data:`MAX_NODES` nodes; a node is a member where a slot with that index
has ``att_mask != 0`` (masks are {0, 1}), and an index outside the image
names none.  What bounds each and how its design answers it is written at
the top of the CUDA source.

The launchers take CUDA tensors and raise on anything else: the torch ops
they stand in for on the card (``models/gpn.py::masked_max`` and
``_keep_sorted_torch``) are the CPU's route and the tests' reference.  The
kernels are forward-only (the test path runs without autograd).
:data:`READOUT_LAUNCHES` and :data:`NMS_LAUNCHES` count their launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._counts import LaunchCounters

# kernel launches through :func:`readout_max` and :func:`nms_keep_sorted`
# (a test or a run resets them); they change only through COUNTS
READOUT_LAUNCHES = 0
NMS_LAUNCHES = 0
COUNTS = LaunchCounters(globals(), ("READOUT_LAUNCHES", "NMS_LAUNCHES"))

MAX_NODES = 64          # a node set is one 64-bit word
# the NMS block keeps a node word and a flag a sub-graph in shared memory:
# 144 KB at this many, of the H100's 227 KB a block
MAX_SUBGRAPHS = 16384
F32 = torch.float32
_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_launch_counts():
    """Zero :data:`READOUT_LAUNCHES` and :data:`NMS_LAUNCHES`."""
    COUNTS.reset()


def _check_lists(obj_ind, att_mask, lead, S, n_obj, who):
    """The node lists as the kernels read them: int64 and float32,
    contiguous, ``lead + (S, N)``; raises on a node count no word holds."""
    if att_mask.shape != obj_ind.shape or obj_ind.shape[:-2] != lead \
            or obj_ind.shape[-2] != S:
        raise ValueError(f"{who}: obj_ind {tuple(obj_ind.shape)} and "
                         f"att_mask {tuple(att_mask.shape)} are not "
                         f"[..., {S}, N] over {tuple(lead)}")
    if not 1 <= n_obj <= MAX_NODES:
        raise ValueError(f"{who}: {n_obj} nodes an image; the kernel holds "
                         f"1 to {MAX_NODES}")
    return (obj_ind.to(torch.int64).contiguous(),
            att_mask.to(F32).contiguous())


def _row_stride(out, lead, S, L):
    """``out``'s row stride where its rows ``lead + (S,)`` lie one stride
    apart in order (unit stride along L), else None."""
    ld = out.stride(-2)
    if (L > 1 and out.stride(-1) != 1) or ld < L:
        return None
    step = S * ld
    for size, stride in zip(reversed(lead), reversed(out.stride()[:-2])):
        if size > 1 and stride != step:
            return None
        step *= size
    return ld


def readout_max(x, obj_ind, att_mask, out=None):
    """The read-out max: ``x [..., n_obj, L]``, ``obj_ind`` / ``att_mask
    [..., S, N]`` -> ``[..., S, L]``, written into ``out`` where given
    (a view whose rows lie one stride apart, such as the max half of a
    read-out, written in place).

    Launches the kernel on the current stream and raises on what it does
    not take: tensors off the card, anything but float32 ``x``, more than
    :data:`MAX_NODES` nodes, an ``out`` whose rows are not one stride
    apart, an input that needs a gradient."""
    lead, (S, _), (n_obj, L) = (obj_ind.shape[:-2], obj_ind.shape[-2:],
                                x.shape[-2:])
    if x.shape[:-2] != lead:
        raise ValueError(f"readout_max: x {tuple(x.shape)} is not "
                         f"[..., n_obj, L] over {tuple(lead)}")
    if out is None:
        out = x.new_empty(lead + (S, L))
    elif out.shape != lead + (S, L):
        raise ValueError(f"readout_max: out {tuple(out.shape)} is not "
                         f"{tuple(lead + (S, L))}")
    if x.device.type != "cuda":
        raise ValueError(f"readout_max: no kernel for {x.device}")
    if x.dtype != F32 or out.dtype != F32:
        raise TypeError(f"readout_max: the kernel takes float32; got x "
                        f"{x.dtype}, out {out.dtype}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("readout_max: the CUDA kernel is forward-only")
    oi, am = _check_lists(obj_ind, att_mask, lead, S, n_obj, "readout_max")
    ld = _row_stride(out, lead, S, L)
    if ld is None:
        raise ValueError(f"readout_max: out's rows (strides "
                         f"{out.stride()}) do not lie one stride apart")
    xc, B = x.contiguous(), lead.numel()
    fn = _build.entry("sgpn", "subgc_readout_max_f32",
                      [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_longlong,
                       _P])
    _build.launch("readout_max kernel", fn, x.device, xc.data_ptr(),
                  oi.data_ptr(), am.data_ptr(), out.data_ptr(), B, S,
                  oi.shape[-1], n_obj, L, ld)
    if B and S and L:       # else nothing to write, and nothing launched
        COUNTS.add({"READOUT_LAUNCHES": 1})
    return out


def nms_keep_sorted(order, obj_ind, att_mask, valid, iou_thres: float,
                    max_keep: int, n_obj: int):
    """Greedy sub-graph NMS: ``order [B, S]`` int64 (the stable score
    order), ``obj_ind`` / ``att_mask [B, S, N]`` and ``valid [B, S]`` bool
    in the original order -> ``keep [B, S]`` bool in score order, at most
    ``max_keep`` an image.  ``iou_thres`` is compared in float32.

    Launches the kernel on the current stream, a block an image, and
    raises on what it does not take: tensors off the card, more than
    :data:`MAX_NODES` nodes or :data:`MAX_SUBGRAPHS` sub-graphs."""
    B, S = order.shape
    if order.device.type != "cuda":
        raise ValueError(f"nms_keep_sorted: no kernel for {order.device}")
    if S > MAX_SUBGRAPHS:
        raise ValueError(f"nms_keep_sorted: {S} sub-graphs an image; the "
                         f"kernel holds {MAX_SUBGRAPHS}")
    oi, am = _check_lists(obj_ind, att_mask, (B,), S, n_obj,
                          "nms_keep_sorted")
    if valid.shape != (B, S) or valid.dtype != torch.bool:
        raise ValueError(f"nms_keep_sorted: valid {valid.dtype} "
                         f"{tuple(valid.shape)} is not bool [{B}, {S}]")
    order, valid = order.to(torch.int64).contiguous(), valid.contiguous()
    keep = torch.empty((B, S), dtype=torch.bool, device=order.device)
    fn = _build.entry("sgpn", "subgc_subgraph_nms",
                      [_P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float,
                       _I, _P])
    _build.launch("nms_keep_sorted kernel", fn, order.device,
                  order.data_ptr(), oi.data_ptr(), am.data_ptr(),
                  valid.data_ptr(), keep.data_ptr(), B, S, oi.shape[-1],
                  n_obj, float(iou_thres), max(0, min(max_keep, S)))
    if B and S:             # else nothing to write, and nothing launched
        COUNTS.add({"NMS_LAUNCHES": 1})
    return keep
