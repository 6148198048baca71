"""Training step: forward + loss + clip + optimizer step (reference
train.py:134-164); the counterpart of ``subgc_tpu/train/step.py``.

The step runs the teacher-forced forward under autograd, sums the language
and sGPN losses, takes the gradients of every parameter leaf and applies
the clipped step of ``tcfg.optim`` (``optim.apply_update``) in place.  Its
metrics stay tensors on the device: the step makes no host sync, and the
caller reads them when it logs.  The multi-device path of the JAX package
is not ported (ROADMAP item 13).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig
from ..graph import SceneGraph
from ..models import subgc
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


def init_train_state(params, model_state, tcfg: TrainConfig,
                     step: int = 0) -> TrainState:
    return TrainState(params=params, model_state=model_state,
                      opt_state=optim.init_opt_state(params, tcfg),
                      step=step)


def _forward_loss(params, model_state, batch: TrainBatch, cfg: ModelConfig,
                  train, generator=None, ss_prob=None):
    logprobs, gpn_loss, _, new_state = subgc.train_forward(
        params, model_state, batch.graph, batch.labels, batch.sub_obj_ind,
        batch.sub_att_mask, batch.img_ix, cfg, train=train,
        generator=generator, ss_prob=ss_prob)
    lang = language_model_loss(logprobs, batch.labels[:, 1:],
                               batch.masks[:, 1:])
    return lang, gpn_loss, new_state


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    ss_active: bool = True):
    """Returns step(ts, batch, generator, epoch, ss_prob) -> (ts, metrics).

    With ``ss_active=False`` scheduled sampling is off and the forward
    hoists the word-embedding gate products out of the step loop (one
    batched matmul, forward and backward); the train CLI uses it for the
    epochs where ss_prob is 0.  ``generator`` (a ``torch.Generator`` on the
    batch's device, or None for no dropout) feeds every dropout and
    scheduled-sampling draw.  metrics: ``loss``, ``lang_loss``,
    ``gpn_loss``, ``lr`` and ``grad_norm``, 0-d tensors.
    """
    use_ss = tcfg.scheduled_sampling_start >= 0 and ss_active

    def step(ts: TrainState, batch: TrainBatch, generator, epoch: int,
             ss_prob: float):
        lang, gpn_loss, new_state = _forward_loss(
            ts.params, ts.model_state, batch, cfg, True, generator,
            ss_prob if use_ss else None)
        total = lang + gpn_loss if gpn_loss is not None else lang
        leaves = optim.tree_leaves(ts.params)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        lr = optim.learning_rate(ts.step, epoch, tcfg)
        opt_state, grad_norm = optim.apply_update(ts.params, grads,
                                                  ts.opt_state, lr, tcfg)
        dev = total.device
        metrics = {"loss": total.detach(), "lang_loss": lang.detach(),
                   "gpn_loss": (gpn_loss.detach() if gpn_loss is not None
                                else torch.zeros((), device=dev)),
                   # a fill kernel, not a host-to-device copy (which syncs)
                   "lr": torch.full((), lr, device=dev),
                   "grad_norm": grad_norm}
        return TrainState(params=ts.params, model_state=new_state,
                          opt_state=opt_state, step=ts.step + 1), metrics

    return step


def make_val_step(cfg: ModelConfig):
    """Validation loss only (misc/eval_utils.py:73-86): the eval-mode
    forward without autograd, so attention runs through the kernels."""
    @torch.no_grad()
    def val_step(params, model_state, batch: TrainBatch):
        return _forward_loss(params, model_state, batch, cfg, False)[0]
    return val_step
