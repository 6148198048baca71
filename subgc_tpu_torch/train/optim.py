"""Optimizer + schedules (reference train.py:100-132, misc/utils.py:223-239);
the counterpart of ``subgc_tpu/train/optim.py``.

The schedules are host functions of (iteration, epoch) computed in float32
as the JAX package's eager ``learning_rate`` computes them (powers by
``_pow_f32``), so every step's learning rate is that function's number.  The
JAX package's jitted step rounds the decay powers differently and can
differ from it in the last bit for decayed epochs.  The update is the JAX
package's
optax chain, ``clip_by_global_norm(10)``, then ``add_decayed_weights(wd)``
when ``weight_decay`` is set, then ``adam(b1, b2, eps)``, written with
``torch._foreach_*`` over the parameter leaves:

* the clip in optax's form, ``g / ||g|| * max`` when ``||g|| >= max`` (not
  ``torch.nn.utils.clip_grad_norm_``, which adds 1e-6 to the norm);
* Adam's bias correction counted from the optimizer's own step, with eps
  outside the square root;
* a parameter that got no gradient (the GCN's gradient-dead units, where
  jax gives zeros) takes a zero gradient, so that weight decay and the
  moments move as optax's do.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..config import TrainConfig


def _pow_f32(x: float, n: int) -> np.float32:
    """``x ** n`` for an integer n >= 0 in float32 by binary
    exponentiation: the rounding of eager jax / numpy ``float32 ** int``,
    which the JAX package's eager ``learning_rate`` matches.  Jitted optax
    rounds ``b ** count`` a few ulps away from it."""
    r, b = np.float32(1.0), np.float32(x)
    while n:
        if n & 1:
            r = np.float32(r * b)
        b = np.float32(b * b)
        n >>= 1
    return r


def learning_rate(it: int, epoch: int, tcfg: TrainConfig) -> float:
    """LR as a function of iteration + epoch (train.py:107-124), in
    float32.

    * linear warmup: lr = it * base / warmup_n for it <= warmup_n (so 0 at
      iteration 0);
    * afterwards: base * rate^((epoch - start) // every) once epoch > start.
    """
    f32 = np.float32
    base = f32(tcfg.learning_rate)
    if it <= tcfg.warmup_n:
        return float(f32(it) * base / f32(tcfg.warmup_n))
    if tcfg.learning_rate_decay_start >= 0 \
            and epoch > tcfg.learning_rate_decay_start:
        frac = (max(epoch - tcfg.learning_rate_decay_start, 0)
                // tcfg.learning_rate_decay_every)
        return float(base * _pow_f32(tcfg.learning_rate_decay_rate, frac))
    return float(base)


def ss_prob(epoch, tcfg: TrainConfig) -> float:
    """Scheduled-sampling probability (train.py:126-132)."""
    if tcfg.scheduled_sampling_start < 0 \
            or epoch <= tcfg.scheduled_sampling_start:
        return 0.0
    frac = (epoch - tcfg.scheduled_sampling_start) \
        // tcfg.scheduled_sampling_increase_every
    return min(tcfg.scheduled_sampling_increase_prob * frac,
               tcfg.scheduled_sampling_max_prob)


def noam_schedule(model_size: int, factor: float = 1.0, warmup: int = 2000):
    """Noam LR schedule (misc/utils.py:269-297): step -> LR."""
    def schedule(step):
        s = float(max(step, 1))
        return factor * model_size ** -0.5 * min(s ** -0.5,
                                                 s * warmup ** -1.5)
    return schedule


class ReduceLROnPlateau:
    """Host-side plateau LR controller (misc/utils.py:299-341): multiply the
    scheduled LR by `factor` when the monitored value stops improving."""

    def __init__(self, factor: float = 0.5, patience: int = 10,
                 threshold: float = 1e-4, min_lr: float = 0.0):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("inf")
        self.bad_epochs = 0
        self.scale = 1.0

    def step(self, value: float) -> float:
        """Feed the monitored metric; returns the current LR scale."""
        if value < self.best * (1.0 - self.threshold):
            self.best = value
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale = max(self.scale * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.scale


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a params tree, in the order the tree lists them."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` over every leaf, keeping the tree's structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


class AdamState(NamedTuple):
    """Adam's step count (host int) and moments (trees shaped as the
    params)."""
    count: int
    mu: dict
    nu: dict


_UNPORTED_OPTIM = {"adamw", "sgd", "rmsprop", "adagrad"}


def init_adam(params, tcfg: TrainConfig) -> AdamState:
    """Zero moments for ``params``.  Only the presets' optimizer, Adam, is
    ported."""
    if tcfg.optim in _UNPORTED_OPTIM:
        raise NotImplementedError(
            f"optim={tcfg.optim!r} is not ported to subgc_tpu_torch yet "
            f"(ROADMAP item 11: no preset uses it)")
    if tcfg.optim != "adam":
        raise ValueError(f"unknown optim {tcfg.optim!r}")

    def zeros(p):
        return torch.zeros_like(p, requires_grad=False)

    return AdamState(count=0, mu=tree_map(zeros, params),
                     nu=tree_map(zeros, params))


@torch.no_grad()
def adam_update(params, grads, opt: AdamState, lr: float,
                tcfg: TrainConfig):
    """One clipped Adam step, in place on the leaves of ``params`` and of
    ``opt``'s moments.  ``grads`` lists a gradient (or None) per leaf of
    ``params``, in :func:`tree_leaves` order.  Returns (new AdamState, the
    global gradient norm before the clip as a 0-d tensor).  No host sync."""
    ps = tree_leaves(params)
    g = [torch.zeros_like(p) if gr is None else gr
         for p, gr in zip(ps, grads)]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
    # optax: where(norm < max, g, g / norm * max)
    under = norm < tcfg.grad_clip_norm
    ones = torch.ones_like(norm)
    g = torch._foreach_div(g, torch.where(under, ones, norm))
    torch._foreach_mul_(g, torch.where(under, ones,
                                       ones * tcfg.grad_clip_norm))
    if tcfg.weight_decay:
        torch._foreach_add_(g, ps, alpha=tcfg.weight_decay)
    # optax holds b1, b2 as float32 hyperparameters: 1 - b rounds in
    # float32 (1 - 0.999 is 1.3e-5 off in float32)
    one = np.float32(1.0)
    b1, b2 = np.float32(tcfg.optim_alpha), np.float32(tcfg.optim_beta)
    count = opt.count + 1
    mu, nu = tree_leaves(opt.mu), tree_leaves(opt.nu)
    torch._foreach_mul_(mu, float(b1))
    torch._foreach_add_(mu, g, alpha=float(one - b1))
    torch._foreach_mul_(nu, float(b2))
    torch._foreach_addcmul_(nu, g, g, value=float(one - b2))
    bc1 = float(one - _pow_f32(b1, count))
    bc2 = float(one - _pow_f32(b2, count))
    den = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, tcfg.optim_epsilon)
    step = torch._foreach_div(mu, bc1)
    torch._foreach_div_(step, den)
    # -lr * update, rounded, then added: optax's two roundings, not an FMA
    torch._foreach_mul_(step, -lr)
    torch._foreach_add_(ps, step)
    return opt._replace(count=count), norm
