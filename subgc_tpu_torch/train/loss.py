"""Training criteria (misc/utils.py:89-156); the counterpart of
``subgc_tpu/train/loss.py``.

Under ``parallel.distributed.data_parallel(group)`` each rank holds a
slice of the batch, and a masked mean divides the rank's masked sum by the
*global* mask count, as the JAX package's one global masked mean does:
summed over the ranks, the losses and their gradients are then the global
ones exactly.  (A mean of the ranks' own means would not be, whenever
their token counts differ.)
"""
from __future__ import annotations

import torch

from ..parallel import distributed as DP


def _global_count(m):
    """``m.sum()``, over every rank of the active data-parallel group."""
    c = m.sum()
    group = DP.active_group()
    return c if group is None else DP.all_reduce_sum(c, group)


def language_model_loss(logprobs, targets, masks):
    """Masked NLL averaged over valid tokens (LanguageModelCriterion,
    misc/utils.py:111-124).

    logprobs [S, T, V+1]; targets/masks [S, >=T] (truncated to T like the
    reference).  Data-parallel: this rank's masked sum over the global
    count.
    """
    T = logprobs.shape[1]
    tgt = targets[:, :T]
    m = masks[:, :T]
    nll = -torch.gather(logprobs, 2, tgt[..., None])[..., 0]
    return (nll * m).sum() / _global_count(m)


def label_smoothing_loss(logprobs, targets, masks, smoothing: float = 0.0):
    """KL-div label smoothing (misc/utils.py:126-156)."""
    T = logprobs.shape[1]
    V = logprobs.shape[-1]
    tgt = targets[:, :T]
    m = masks[:, :T]
    true_dist = torch.full_like(logprobs, smoothing / (V - 1))
    true_dist = true_dist.scatter(-1, tgt[..., None], 1.0 - smoothing)
    # torch KLDivLoss(input=logprobs, target=dist) = dist*(log dist - input)
    log_td = torch.where(true_dist > 0, torch.log(true_dist),
                         torch.zeros_like(true_dist))
    kl = (true_dist * (log_td - logprobs)).sum(-1)
    return (kl * m).sum() / m.sum()


def reward_loss(sample_logprobs, seq, reward, gpn_loss=None):
    """SCST-style policy-gradient loss (RewardCriterion,
    misc/utils.py:89-109); data-parallel: this rank's sum over the global
    mask count."""
    lp = sample_logprobs.reshape(-1)
    r = reward.reshape(-1)
    mask = (seq > 0).to(torch.float32)
    mask = torch.cat([torch.ones_like(mask[:, :1]), mask[:, :-1]],
                     dim=1).reshape(-1)
    if gpn_loss is None:
        out = -lp * r * mask
    else:
        g = gpn_loss[:, None].expand(gpn_loss.shape[0],
                                     seq.shape[1]).reshape(-1)
        out = (-lp * r + g * torch.exp(r)) * mask
    return out.sum() / _global_count(mask)
