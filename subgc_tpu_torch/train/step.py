"""Training step: forward + loss + clip + optimizer step (reference
train.py:134-164); the counterpart of ``subgc_tpu/train/step.py``.

The step runs the teacher-forced forward under autograd, sums the language
and sGPN losses, takes the gradients of every parameter leaf and applies
the clipped step of ``tcfg.optim`` (``optim.apply_update``) in place.  Its
metrics stay tensors on the device: the step makes no host sync, and the
caller reads them when it logs.

Data-parallel training (``group``, one process per card): each rank runs
the forward on its slice of the global batch (:func:`local_train_batch`)
under ``parallel.distributed.data_parallel``, which makes its draws,
BatchNorm moments and loss normalisation global; the gradients are then
summed over the ranks in one flat bucket, where the JAX package's sharded
jit inserts a psum, and every rank clips and steps on the same bits.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig
from ..graph import SceneGraph
from ..models import subgc
from ..parallel import distributed as DP
from ..utils.profiling import span
from . import optim
from .loss import language_model_loss


class TrainBatch(NamedTuple):
    """One training batch (the tensors of dataloader.py:189-206); numpy on
    the host, tensors after :func:`batch_to_device`."""
    graph: SceneGraph          # [B, ...]
    labels: object             # [S, T+2] int (S = B*seq_per_img)
    masks: object              # [S, T+2] float32
    sub_obj_ind: object        # [S, 2, half, N] int
    sub_att_mask: object       # [S, 2, half, N] float32
    img_ix: object             # [S] int


class TrainState(NamedTuple):
    params: dict               # leaves that require grad
    model_state: dict          # BatchNorm running statistics
    opt_state: optim.OptState
    step: int                  # the reference's `iteration`


def batch_to_device(batch: TrainBatch, device,
                    non_blocking: bool = False) -> TrainBatch:
    """A host TrainBatch as tensors on ``device`` (index arrays int64).
    With ``non_blocking`` (a CUDA device) each host tensor is pinned and
    copied without blocking, on the current stream: the caller orders its
    readers after that stream (``data/prefetch.py``)."""
    def t(x, dtype=None):
        h = torch.from_numpy(np.ascontiguousarray(x))
        if dtype is None:
            dtype = torch.int64 if h.dtype in (torch.int32, torch.int64) \
                else h.dtype
        h = h.to(dtype)
        if non_blocking:
            h = h.pin_memory()
        return h.to(device, non_blocking=non_blocking)

    return TrainBatch(graph=SceneGraph(*(t(x) for x in batch.graph)),
                      labels=t(batch.labels, torch.int64),
                      masks=t(batch.masks, torch.float32),
                      sub_obj_ind=t(batch.sub_obj_ind, torch.int64),
                      sub_att_mask=t(batch.sub_att_mask, torch.float32),
                      img_ix=t(batch.img_ix, torch.int64))


def local_train_batch(batch: TrainBatch, rank: int, world: int
                      ) -> TrainBatch:
    """Rank ``rank``'s slice of a global host TrainBatch (every leaf's
    leading axis cut proportionally, ``parallel.distributed.
    slice_local_shards``), with ``img_ix`` rebased onto the rank's own
    images."""
    if world <= 1:
        return batch
    local = DP.slice_local_shards(batch, rank, world)
    per = np.asarray(batch.graph.obj_fmap).shape[0] // world
    return local._replace(img_ix=np.asarray(local.img_ix) - rank * per)


def init_train_state(params, model_state, tcfg: TrainConfig,
                     step: int = 0) -> TrainState:
    return TrainState(params=params, model_state=model_state,
                      opt_state=optim.init_opt_state(params, tcfg),
                      step=step)


def _forward_loss(params, model_state, batch: TrainBatch, cfg: ModelConfig,
                  train, generator=None, ss_prob=None, group=None):
    with DP.data_parallel(group):
        logprobs, gpn_loss, _, new_state = subgc.train_forward(
            params, model_state, batch.graph, batch.labels,
            batch.sub_obj_ind, batch.sub_att_mask, batch.img_ix, cfg,
            train=train, generator=generator, ss_prob=ss_prob)
        lang = language_model_loss(logprobs, batch.labels[:, 1:],
                                   batch.masks[:, 1:])
    return lang, gpn_loss, new_state


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    ss_active: bool = True, group=None):
    """Returns step(ts, batch, generator, epoch, ss_prob, grads_out=None)
    -> (ts, metrics).

    With ``ss_active=False`` scheduled sampling is off and the forward
    hoists the word-embedding gate products out of the step loop (one
    batched matmul, forward and backward); the train CLI uses it for the
    epochs where ss_prob is 0.  ``generator`` (a ``torch.Generator`` on the
    batch's device, or None for no dropout) feeds every dropout and
    scheduled-sampling draw.  metrics: ``loss``, ``lang_loss``,
    ``gpn_loss``, ``lr`` and ``grad_norm``, 0-d tensors.  ``grads_out``, a
    list, receives the gradients the optimizer is given (summed over the
    ranks), one per leaf of ``optim.tree_leaves(ts.params)``.

    ``group``: a data-parallel process group; ``batch`` is then this
    rank's :func:`local_train_batch`, every rank's generator is seeded
    alike, and the step is the global batch's (the metrics too).
    """
    use_ss = tcfg.scheduled_sampling_start >= 0 and ss_active

    def step(ts: TrainState, batch: TrainBatch, generator, epoch: int,
             ss_prob: float, grads_out=None):
        with span("subgc.train.step"):
            with span("subgc.train.forward"):
                lang, gpn_loss, new_state = _forward_loss(
                    ts.params, ts.model_state, batch, cfg, True, generator,
                    ss_prob if use_ss else None, group)
                total = lang + gpn_loss if gpn_loss is not None else lang
            leaves = optim.tree_leaves(ts.params)
            with span("subgc.train.backward"):
                grads = torch.autograd.grad(total, leaves, allow_unused=True)
                if group is not None:
                    grads = DP.all_reduce_gradients(grads, leaves, group)
            if grads_out is not None:
                grads_out.extend(grads)
            with span("subgc.train.optim"):
                lr = optim.learning_rate(ts.step, epoch, tcfg)
                opt_state, grad_norm = optim.apply_update(
                    ts.params, grads, ts.opt_state, lr, tcfg)
            dev = total.device
            gpn = (gpn_loss.detach() if gpn_loss is not None
                   else torch.zeros((), device=dev))
            losses = torch.stack([total.detach(), lang.detach(), gpn])
            if group is not None:   # each rank's share of the global means
                torch.distributed.all_reduce(losses, group=group)
            metrics = {"loss": losses[0], "lang_loss": losses[1],
                       "gpn_loss": losses[2],
                       # a fill kernel, not a host-to-device copy (which
                       # syncs)
                       "lr": torch.full((), lr, device=dev),
                       "grad_norm": grad_norm}
            return TrainState(params=ts.params, model_state=new_state,
                              opt_state=opt_state, step=ts.step + 1), metrics

    return step


def make_val_step(cfg: ModelConfig, group=None):
    """Validation loss only (misc/eval_utils.py:73-86): the eval-mode
    forward without autograd, so attention runs through the kernels.
    ``group``: ``batch`` is this rank's slice and the loss the global
    batch's, on every rank."""
    @torch.no_grad()
    def val_step(params, model_state, batch: TrainBatch):
        lang = _forward_loss(params, model_state, batch, cfg, False,
                             group=group)[0]
        if group is not None:
            torch.distributed.all_reduce(lang, group=group)
        return lang
    return val_step
