"""Process groups for data-parallel training; the counterpart of
``subgc_tpu/parallel/distributed.py``.

The JAX package runs one process per host: ``jax.distributed.initialize``
joins the hosts, and XLA inserts the gradient psum of its sharded train
step.  Here a *process is one card* (or, on the CPU, one worker): the ranks
join a ``torch.distributed`` process group (NCCL on the cards, gloo on the
CPU), every rank assembles the same global batch from the same seed and
keeps its own slice (:func:`slice_local_shards`), and the train step sums
the gradients by hand (:func:`all_reduce_gradients`).  So that the step
computes the global batch's result whatever the number of ranks, the
forward runs under :func:`data_parallel`:

* every random draw (dropout, scheduled sampling, categorical draws) takes
  the *global* batch's shape from the shared-seed generator, and each rank
  keeps its own rows (:func:`rand_rows`), as JAX draws one key over the
  global array;
* BatchNorm's moments are global (:func:`all_reduce_sum`, differentiable,
  so that the moments' gradient crosses ranks, as in SyncBatchNorm);
* the losses divide each rank's sum by the global count, and the summed
  gradients are then the global loss's gradient.

Without a group every function here is the single-process one.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import tree_map


def maybe_initialize_distributed(coordinator: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None,
                                 backend: Optional[str] = None) -> bool:
    """Join a process group when one is configured; a no-op otherwise.

    Reads ``SUBGC_COORDINATOR`` (``host:port`` of rank 0),
    ``SUBGC_NUM_PROCESSES`` and ``SUBGC_PROCESS_ID`` when the arguments are
    None; with none of them set and ``SUBGC_AUTO_DISTRIBUTED=1`` it takes
    the ``env://`` variables that ``torchrun`` sets (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  ``backend`` defaults to
    NCCL where a card is attached, gloo otherwise.  Each process is one
    card: the caller places its work on :func:`rank_device`.  Returns
    whether a group is up (also when it already was).
    """
    if dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get("SUBGC_COORDINATOR")
    num_processes = num_processes or _int_env("SUBGC_NUM_PROCESSES")
    process_id = process_id if process_id is not None \
        else _int_env("SUBGC_PROCESS_ID")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if coordinator is None and num_processes is None:
        if os.environ.get("SUBGC_AUTO_DISTRIBUTED") == "1":
            dist.init_process_group(backend, init_method="env://")
            return True
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("SUBGC_COORDINATOR, SUBGC_NUM_PROCESSES and "
                         "SUBGC_PROCESS_ID go together")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return True


def _int_env(name):
    v = os.environ.get(name)
    return int(v) if v is not None else None


def get_process_index(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def get_process_count(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank_device(device_type: str = "cuda") -> torch.device:
    """This process's device: on the cards ``cuda:LOCAL_RANK`` (torchrun's
    variable; else the rank modulo the attached cards), else the CPU."""
    if device_type != "cuda":
        return torch.device(device_type)
    local = _int_env("LOCAL_RANK")
    if local is None:
        local = get_process_index() % max(torch.cuda.device_count(), 1)
    return torch.device("cuda", local)


def local_batch_slice(global_batch: int, process_index: Optional[int] = None,
                      process_count: Optional[int] = None) -> slice:
    """This process's slice of a globally sharded batch."""
    pc = process_count if process_count is not None \
        else get_process_count()
    pi = process_index if process_index is not None \
        else get_process_index()
    per = global_batch // pc
    return slice(pi * per, (pi + 1) * per)


def slice_local_shards(tree, process_index: Optional[int] = None,
                       process_count: Optional[int] = None):
    """Each process's slice of every leading axis of a global host batch.

    TrainBatch leaves carry different leading multipliers (B images, B *
    seq_per_img sentences), all divisible by the process count, so a
    per-leaf proportional slice keeps image boundaries intact.  Index
    leaves that point into another leaf's rows (``img_ix``) keep their
    global values: ``train.step.local_train_batch`` rebases them.
    """
    pc = process_count if process_count is not None \
        else get_process_count()
    if pc <= 1:
        return tree
    pi = process_index if process_index is not None \
        else get_process_index()

    def cut(x):
        per = x.shape[0] // pc
        return x[pi * per:(pi + 1) * per]

    return tree_map(cut, tree)


# ---- the data-parallel forward

class _Active(threading.local):
    group = None
    rank = 0
    world = 1


_ACTIVE = _Active()


@contextlib.contextmanager
def data_parallel(group):
    """Within: :func:`rand_rows` draws the global batch's shape and keeps
    this rank's rows, and :func:`active_group` gives ``group`` to the
    forward's BatchNorm and losses.  ``group`` None changes nothing."""
    prev = (_ACTIVE.group, _ACTIVE.rank, _ACTIVE.world)
    if group is not None:
        _ACTIVE.group = group
        _ACTIVE.rank = dist.get_rank(group)
        _ACTIVE.world = dist.get_world_size(group)
    try:
        yield
    finally:
        _ACTIVE.group, _ACTIVE.rank, _ACTIVE.world = prev


def active_group():
    """The group of the enclosing :func:`data_parallel`, or None."""
    return _ACTIVE.group


def rand_rows(shape, generator, device, dtype=torch.float32, axis: int = 0):
    """``torch.rand(shape)``; under :func:`data_parallel` with W ranks the
    draw is ``shape`` with axis ``axis`` (the batch axis) W times longer,
    and this rank keeps its own contiguous rows, so that every rank's
    slice is what one process drawing the global batch would draw."""
    if _ACTIVE.group is None or _ACTIVE.world == 1:
        return torch.rand(shape, generator=generator, device=device,
                          dtype=dtype)
    shape = list(shape)
    n = shape[axis]
    shape[axis] = n * _ACTIVE.world
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return u.narrow(axis, _ACTIVE.rank * n, n)


# ---- collectives

def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the group's ranks, differentiable: its
    backward sums the incoming gradients over the ranks too
    (``torch.distributed.nn.functional.all_reduce``), so that a rank's
    gradient holds every rank's use of the sum.  A plain
    ``dist.all_reduce`` under autograd would drop that term."""
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t, op=dist.ReduceOp.SUM, group=group)


def all_reduce_gradients(grads, leaves, group=None):
    """Sum a step's gradients over the group in one flat bucket: flatten
    every gradient (a None, for a leaf the loss does not reach, as zeros),
    all-reduce the bucket, cut it back into the leaves' shapes.  Every
    rank gets the same bits."""
    parts = [(g if g is not None else torch.zeros_like(p)).reshape(-1)
             for g, p in zip(grads, leaves)]
    bucket = torch.cat(parts)
    dist.all_reduce(bucket, op=dist.ReduceOp.SUM, group=group)
    out, i = [], 0
    for p in leaves:
        out.append(bucket[i:i + p.numel()].view_as(p))
        i += p.numel()
    return out


def all_gather_arrays(x: np.ndarray, group=None) -> list:
    """Every rank's host array, in rank order, gathered as pickled objects
    on the host (gloo does not all-gather CUDA tensors)."""
    out = [None] * get_process_count(group)
    dist.all_gather_object(out, x, group=group)
    return out
