"""Optimizer + schedules (reference train.py:100-132, misc/utils.py:223-239);
the counterpart of ``subgc_tpu/train/optim.py``.

The schedules are host functions of (iteration, epoch) computed in float32
as the JAX package's eager ``learning_rate`` computes them (powers by
``_pow_f32``), so every step's learning rate is that function's number.  The
JAX package's jitted step rounds the decay powers differently and can
differ from it in the last bit for decayed epochs.

The update is the JAX package's optax chain (``build_optimizer``,
``subgc_tpu/train/optim.py:45-65``) for each of its five optimizers,
written with ``torch._foreach_*`` over the parameter leaves: first
``clip_by_global_norm(10)``, then the optimizer's transform, then the
injected learning rate, ``-lr * update``, added to the params.  Where optax
and ``torch.optim`` differ, this follows optax (optax 0.2.6 source):

* the clip in optax's form, ``g / ||g|| * max`` when ``||g|| >= max`` (not
  ``torch.nn.utils.clip_grad_norm_``, which adds 1e-6 to the norm), the
  norm as accurate as optax's (:func:`global_norm`);
* ``adam``: ``scale_by_adam(optim_alpha, optim_beta, optim_epsilon)``
  (``optax/_src/transform.py:246-311``), bias correction counted from the
  optimizer's own step, eps outside the square root; ``weight_decay`` > 0
  chains ``add_decayed_weights`` BEFORE it (L2 on the gradient,
  ``subgc_tpu/train/optim.py:66-67``), for ``adam`` only;
* ``adamw``: optax's own ``b1, b2, eps`` (0.9, 0.999, 1e-8), not the
  config's, then ``add_decayed_weights(0.01)`` on the Adam update, before
  the learning rate (decoupled; ``optax/_src/alias.py:599-700``,
  ``optax/transforms/_adding.py:36-70``);
* ``sgd``: ``trace(decay=0.9)``, ``t = g + 0.9 t`` from zero, no Nesterov
  (``optax/_src/alias.py:2010-2070``, ``optax/transforms/_accumulation.py:
  37-75``);
* ``rmsprop``: ``scale_by_rms(decay=optim_alpha, eps=optim_epsilon)``,
  ``nu = (1 - d) g^2 + d nu`` from zero, update ``g * rsqrt(nu + eps)``
  with eps INSIDE the root (``optax/_src/transform.py:95-158``;
  ``torch.optim.RMSprop`` puts it outside);
* ``adagrad``: ``scale_by_rss(initial_accumulator_value=0.1, eps=1e-7)``,
  ``s = g^2 + s`` from 0.1, update ``g * rsqrt(s + eps)`` where ``s > 0``
  (``optax/_src/transform.py:46-77``; ``torch.optim.Adagrad`` starts at 0
  and puts eps outside the root).

Optax holds every injected hyperparameter as a float32 array, so ``1 - b``
and the like round in float32 here too.  A parameter that got no gradient
(the GCN's gradient-dead units, where jax gives zeros) takes a zero
gradient, so that weight decay and the moments move as optax's do.
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


# each optimizer's named moments (trees shaped as the params), as optax
# names its state's fields
MOMENTS = {"adam": ("mu", "nu"), "adamw": ("mu", "nu"), "sgd": ("trace",),
           "rmsprop": ("nu",), "adagrad": ("sum_of_squares",)}
ADAMW = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
SGD_MOMENTUM = 0.9
ADAGRAD = dict(initial_accumulator_value=0.1, eps=1e-7)


class OptState(NamedTuple):
    """An optimizer's state: its kind (a key of :data:`MOMENTS`), its step
    count (host int) and its named moments (trees shaped as the params)."""
    kind: str
    count: int
    moments: dict

    @property
    def mu(self):
        return self.moments["mu"]

    @property
    def nu(self):
        return self.moments["nu"]


def init_opt_state(params, tcfg: TrainConfig) -> OptState:
    """The initial state of ``tcfg.optim`` for ``params``: zero moments,
    but adagrad's sum of squares, which starts at 0.1."""
    if tcfg.optim not in MOMENTS:
        raise ValueError(f"unknown optim {tcfg.optim!r}; one of "
                         f"{sorted(MOMENTS)}")
    fill = ADAGRAD["initial_accumulator_value"] \
        if tcfg.optim == "adagrad" else 0.0

    def full(p):
        return torch.full_like(p, fill, requires_grad=False)

    return OptState(kind=tcfg.optim, count=0,
                    moments={k: tree_map(full, params)
                             for k in MOMENTS[tcfg.optim]})


def _ema_(moment, x, decay):
    """``moment = (1 - decay) * x + decay * moment`` in place, each product
    rounded before the sum, as optax's ``tree_update_moment`` (no fused
    multiply-add); ``decay`` a float32 number."""
    x = torch._foreach_mul(x, float(np.float32(1.0) - decay))
    torch._foreach_mul_(moment, float(decay))
    torch._foreach_add_(moment, x)


def _adam_direction(g, mu, nu, count, b1, b2, eps):
    """optax ``scale_by_adam``'s update, in place on the moments: returns
    ``mu_hat / (sqrt(nu_hat) + eps)`` per leaf."""
    one = np.float32(1.0)
    b1, b2 = np.float32(b1), np.float32(b2)
    _ema_(mu, g, b1)
    _ema_(nu, torch._foreach_mul(g, g), b2)
    bc1 = float(one - _pow_f32(b1, count))
    bc2 = float(one - _pow_f32(b2, count))
    den = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, float(np.float32(eps)))
    step = torch._foreach_div(mu, bc1)
    torch._foreach_div_(step, den)
    return step


def global_norm(g) -> torch.Tensor:
    """optax ``global_norm``: the square root of the sum over the leaves of
    each leaf's sum of squares, as a 0-d tensor.  On CUDA tensors one
    ``_foreach_norm`` launch computes it with tree reductions; on the CPU
    torch's norm kernels sum float32 squares one after another (2.9e-4
    relative off at a 9.5M-element leaf, the logit weight), so there each
    leaf's ``sum(g * g)``, which sums pairwise, as optax's does."""
    if g[0].is_cuda:
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
    return torch.sqrt(sum(torch.sum(x * x) for x in g))


@torch.no_grad()
def apply_update(params, grads, opt: OptState, lr: float,
                 tcfg: TrainConfig):
    """One clipped step of ``opt``'s optimizer, in place on the leaves of
    ``params`` and of ``opt``'s moments.  ``grads`` lists a gradient (or
    None) per leaf of ``params``, in :func:`tree_leaves` order.  Returns
    (new OptState, the global gradient norm before the clip as a 0-d
    tensor).  No host sync."""
    if opt.kind != tcfg.optim:
        raise ValueError(f"optimizer state is {opt.kind!r}, the config "
                         f"asks for {tcfg.optim!r}")
    ps = tree_leaves(params)
    g = [torch.zeros_like(p) if gr is None else gr
         for p, gr in zip(ps, grads)]
    norm = global_norm(g)
    # optax: where(norm < max, g, g / norm * max)
    under = norm < tcfg.grad_clip_norm
    ones = torch.ones_like(norm)
    g = torch._foreach_div(g, torch.where(under, ones, norm))
    torch._foreach_mul_(g, torch.where(under, ones,
                                       ones * tcfg.grad_clip_norm))
    count = opt.count + 1
    m = {k: tree_leaves(v) for k, v in opt.moments.items()}
    f32 = np.float32
    if opt.kind == "adam":
        if tcfg.weight_decay:
            torch._foreach_add_(g, torch._foreach_mul(
                ps, float(f32(tcfg.weight_decay))))
        step = _adam_direction(g, m["mu"], m["nu"], count, tcfg.optim_alpha,
                               tcfg.optim_beta, tcfg.optim_epsilon)
    elif opt.kind == "adamw":
        step = _adam_direction(g, m["mu"], m["nu"], count, ADAMW["b1"],
                               ADAMW["b2"], ADAMW["eps"])
        torch._foreach_add_(step, torch._foreach_mul(
            ps, float(f32(ADAMW["weight_decay"]))))
    elif opt.kind == "sgd":
        torch._foreach_mul_(m["trace"], float(f32(SGD_MOMENTUM)))
        torch._foreach_add_(m["trace"], g)
        step = [t.clone() for t in m["trace"]]
    elif opt.kind == "rmsprop":
        _ema_(m["nu"], torch._foreach_mul(g, g), f32(tcfg.optim_alpha))
        step = torch._foreach_add(m["nu"], float(f32(tcfg.optim_epsilon)))
        torch._foreach_rsqrt_(step)
        torch._foreach_mul_(step, g)
    else:                                               # adagrad
        torch._foreach_add_(m["sum_of_squares"], torch._foreach_mul(g, g))
        step = torch._foreach_add(m["sum_of_squares"],
                                  float(f32(ADAGRAD["eps"])))
        torch._foreach_rsqrt_(step)
        # where(s > 0, rsqrt(s + eps), 0): s >= 0.1 > 0 throughout
        torch._foreach_mul_(step, g)
    # -lr * update, rounded, then added: optax's two roundings, not an FMA
    torch._foreach_mul_(step, -lr)
    torch._foreach_add_(ps, step)
    return opt._replace(count=count), norm
