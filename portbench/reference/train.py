"""The training step in plain PyTorch: the teacher-forced loss
(`models/AttModel.py:122-177`, `models/lib/gpn.py:41-81`,
`misc/utils.py:111-124`) under autograd, and the clipped Adam update
(`train.py:134-164`; optax's ``clip_by_global_norm`` then ``adam``).

Dropout masks are drawn from a ``torch.Generator`` that the caller seeds,
one ``torch.rand`` per dropout site in the order the model meets them
(sGPN hidden layer, fc embedding, node embedding, word embeddings of all
steps, each step's output), so that a program drawing its masks from a
generator seeded alike, in that order, sees the same masks."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import model as M


def leaves(tree, prefix=""):
    """(path, tensor) of every leaf of a weights tree, in its order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in leaves(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def loss(w, state, cfg, batch, gen, drop_prob):
    """Total training loss (language + sGPN BCE) of one batch, and the new
    BatchNorm state.  batch: dict of tensors obj_fmap, obj_dist, rel_ind,
    pred_dist [B, ...], labels / masks [S, T+2], sub_obj_ind / sub_att_mask
    [S, 2, half, N], img_ix [S]."""
    def rand(shape, dev):
        return torch.rand(shape, generator=gen, device=dev)

    def drop(x):
        keep = rand(x.shape, x.device) < 1.0 - drop_prob
        return torch.where(keep, x / (1.0 - drop_prob), torch.zeros_like(x))

    x_obj, new_state = M.encode(w, state, cfg, batch, train=True)
    img_ix = batch["img_ix"]
    S = img_ix.shape[0]
    ar = torch.arange(S, device=img_ix.device)
    gpn = None
    if cfg["use_gpn"]:
        soi, sam = batch["sub_obj_ind"], batch["sub_att_mask"]
        read_out = M.pool_readout(x_obj[img_ix[:, None, None, None], soi],
                                  sam)                     # [S, 2, half, 2L]
        keep = rand(read_out.shape[:-1] + (cfg["gpn_hid_dim"],),
                    x_obj.device) < 0.5
        logits = M.sgpn_logits(w, read_out, keep)
        target = torch.zeros_like(logits)
        target[:, 0] = 1.0
        log_s = torch.clamp(-F.softplus(-logits), min=-100.0)
        log_1s = torch.clamp(-F.softplus(logits), min=-100.0)
        gpn = -(target * log_s + (1 - target) * log_1s).mean()
        best = torch.argmax(torch.sigmoid(logits)[:, 0], -1)
        att_feats = x_obj[img_ix[:, None], soi[ar, 0, best]]
        att_mask = sam[ar, 0, best]
        fc_feats = M.readout_project(w, read_out[ar, 0, best].detach())
    else:
        att_feats = x_obj[img_ix]
        ro = w["readout"]
        fc_feats = M.dense(M.dense(att_feats.mean(1).detach(),
                                   ro["readout1"]), ro["readout2"])
        att_mask = torch.ones(att_feats.shape[:2], device=x_obj.device)
        att_mask[:, -1] = 0.0                    # the dummy node
    feats = M.prepare(w, cfg, fc_feats, att_feats, att_mask, drop=drop)
    labels = batch["labels"]
    T = labels.shape[1] - 1
    R = cfg["rnn_size"]
    d = w["decoder"]
    xt = drop(torch.relu(d["embed"][labels[:, :T].T]))       # [T, S, E]
    xt_ih = xt @ d["att_lstm"]["w_ih"][2 * R:]
    st = M.zero_state((S,), cfg, x_obj.device)
    lps = []
    for i in range(T):
        lp, st = M.step(w, cfg, st, xt_ih[i], feats, out_drop=drop)
        lps.append(lp)
    lp = torch.stack(lps, 1)
    m = batch["masks"][:, 1:T + 1]
    nll = -torch.gather(lp, 2, labels[:, 1:T + 1, None])[..., 0]
    lang = (nll * m).sum() / m.sum()
    return (lang + gpn if gpn is not None else lang), new_state


class Adam:
    """optax ``chain(clip_by_global_norm(clip), adam(b1, b2, eps))`` with
    the update ``-lr * direction``, over a list of leaves."""

    def __init__(self, params, clip=10.0, b1=0.9, b2=0.999, eps=1e-8):
        self.clip, self.b1, self.b2, self.eps = clip, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, params, grads, lr):
        """Update ``params`` in place; returns the clipped gradients."""
        norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
        scale = 1.0 if norm < self.clip else self.clip / norm
        grads = [g * scale for g in grads]
        self.count += 1
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            p.sub_(lr * (mu / c1) / (torch.sqrt(nu / c2) + self.eps))
        return grads


def run_steps(w, state, cfg, batches, seed, lr, drop_prob, n_steps):
    """``n_steps`` training steps from weights ``w`` (updated in place) on
    ``batches``, dropout drawn from a generator seeded with ``seed`` on the
    weights' device.  Returns (losses, first clipped gradients by path)."""
    dev = leaves(w)[0][1].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    paths, params = zip(*leaves(w))
    for p in params:
        p.requires_grad_(True)
    opt = Adam(params)
    losses, first = [], None
    for i in range(n_steps):
        total, state = loss(w, state, cfg, batches[i], gen, drop_prob)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        clipped = opt.step(params, grads, lr)
        if first is None:
            first = {k: g.detach() for k, g in zip(paths, clipped)}
        losses.append(float(total.detach()))
    for p in params:
        p.requires_grad_(False)
    return losses, first
