"""The test path in plain PyTorch: sub-graph scores, NMS, the kept rows'
decoder inputs, teacher-forced log-probabilities of given captions, and
greedy and beam search (`models/AttModel.py:179-326`,
`models/CaptionModel.py:28-176`), for one image at a time."""
from __future__ import annotations

import numpy as np
import torch

from . import model as M


def score_subgraphs(w, cfg, x_obj, obj_ind, att_mask):
    """sGPN test scores (gpn.py:83-97) of one image's sub-graphs.
    x_obj [N, L]; obj_ind / att_mask [S, N].  Returns (scores [S],
    read_out [S, 2L], membership [S, N])."""
    read_out = M.pool_readout(x_obj[obj_ind], att_mask)
    scores = torch.sigmoid(M.sgpn_logits(w, read_out))
    return scores, read_out, M.node_sets(obj_ind, att_mask, x_obj.shape[0])


def row_inputs(w, cfg, x_obj, obj_ind, att_mask, read_out):
    """Decoder inputs of the kept rows: obj_ind / att_mask [K, N] and
    read_out [K, 2L] of the kept sub-graphs of the image x_obj [N, L]."""
    fc_feats = M.readout_project(w, read_out)
    return M.prepare(w, cfg, fc_feats, x_obj[obj_ind], att_mask)


def teacher(w, cfg, feats, tokens):
    """Log-probabilities [S, T, V+1] at each position of ``tokens`` [S, T]
    (the first input is BOS, token 0), fed the given tokens."""
    S, T = tokens.shape
    state = M.zero_state((S,), cfg, tokens.device)
    prev = torch.zeros((S,), dtype=torch.long, device=tokens.device)
    out = []
    for t in range(T):
        lp, state = M.step(w, cfg, state, M.word_ih(w, cfg, prev), feats)
        out.append(lp)
        prev = tokens[:, t]
    return torch.stack(out, 1)


def greedy(w, cfg, feats, T):
    """Greedy decode (argmax, first index on ties); a caption ends at its
    first token 0 and holds zeros after it.  Returns (tokens, each chosen
    token's log-probability) [S, T]."""
    S = feats["fc_ih"].shape[0]
    dev = feats["fc_ih"].device
    state = M.zero_state((S,), cfg, dev)
    it = torch.zeros((S,), dtype=torch.long, device=dev)
    live = torch.ones((S,), dtype=torch.bool, device=dev)
    seq, lps = [], []
    for _ in range(T):
        lp, state = M.step(w, cfg, state, M.word_ih(w, cfg, it), feats)
        nxt = torch.argmax(lp, -1)
        lps.append(torch.gather(lp, 1, nxt[:, None])[:, 0])
        live = live & (nxt > 0)
        it = nxt * live
        seq.append(it)
    return torch.stack(seq, 1), torch.stack(lps, 1)


def beam(w, cfg, feats, bdash, T, rank=1):
    """Beam search with ``bdash`` beams (CaptionModel.py, one group, no
    length penalty): the unknown-word column takes -1000, t = 0 expands
    beam 0 only, a beam is done at token 0 or at the last step and its
    running sum then falls to -1000, and the best done beam is the caption
    (ties to the earlier step, then the lower beam).  Returns the
    ``rank``-th best done beam's (tokens, each token's log-probability)
    [S, T] and summed log-probability [S] (1: the caption; a fault of
    ``control.py`` takes 2), and each row's margin [S]: the least gap at a
    decision of the search that a rounding could turn, between the last
    kept and the first dropped live candidate of a step, and between the
    best done beam and the next."""
    S = feats["fc_ih"].shape[0]
    dev = feats["fc_ih"].device
    rows = torch.arange(S, device=dev)[:, None]
    state = M.zero_state((S, bdash), cfg, dev)
    tok = torch.zeros((S, bdash), dtype=torch.long, device=dev)
    seqs = torch.zeros((S, bdash, T), dtype=torch.long, device=dev)
    seq_lps = torch.zeros((S, bdash, T), device=dev)
    sums = torch.zeros((S, bdash), device=dev)
    inf = float("inf")
    margin = torch.full((S,), inf, device=dev)
    done_v = torch.full((S, T, bdash), -inf, device=dev)
    done_seq = torch.zeros((S, T, bdash, T), dtype=torch.long, device=dev)
    done_lps = torch.zeros((S, T, bdash, T), device=dev)
    for t in range(T):
        lp, state = M.step(w, cfg, state, M.word_ih(w, cfg, tok), feats)
        lp = lp.clone()
        lp[..., -1] -= 1000.0
        cand = sums[..., None] + lp
        if t == 0:
            cand[:, 1:] = -inf
        # word-major order: ties go to the lower word, then the lower beam
        flat = cand.transpose(1, 2).reshape(S, -1).clone()
        vals, qs, cs = [], [], []
        for _ in range(bdash + 1):       # the kept ones and the first dropped
            r = torch.argmax(flat, -1, keepdim=True)
            vals.append(torch.gather(flat, 1, r)[:, 0])
            qs.append((r % bdash)[:, 0])
            cs.append((r // bdash)[:, 0])
            flat.scatter_(1, r, -inf)
        dropped = vals.pop()
        vals, q, c = (torch.stack(x[:bdash], 1) for x in (vals, qs, cs))
        # a continuation of a done beam sits near -1000: no live choice
        margin = torch.minimum(margin, torch.where(
            dropped > -500.0, vals[:, -1] - dropped,
            torch.full_like(dropped, inf)))
        seqs = seqs[rows, q]
        seqs[..., t] = c
        seq_lps = seq_lps[rows, q]
        seq_lps[..., t] = lp[rows, q, c]
        state = tuple(x[rows, q] for x in state)
        done = (c == 0) | (t == T - 1)
        done_v[:, t] = torch.where(done, vals, torch.full_like(vals, -inf))
        done_seq[:, t] = seqs
        done_lps[:, t] = seq_lps
        sums = torch.where(done, torch.full_like(vals, -1000.0), vals)
        tok = c
    # stable: equal sums keep the earlier step, then the lower beam
    order = torch.sort(done_v.reshape(S, -1), dim=-1, descending=True,
                       stable=True)
    top = order.values[:, :2]
    margin = torch.minimum(margin, torch.where(
        torch.isfinite(top[:, 1]), top[:, 0] - top[:, 1],
        torch.full_like(margin, inf)))
    pick = order.indices[:, rank - 1]
    return (done_seq.reshape(S, T * bdash, T)[rows[:, 0], pick],
            done_lps.reshape(S, T * bdash, T)[rows[:, 0], pick],
            order.values[:, rank - 1], margin)


def _served(tokens):
    """[S, T]: the positions up to and including each caption's first token
    0 (after it, padding)."""
    ended = torch.cumsum((tokens == 0).long(), 1)
    return torch.cat([torch.zeros_like(ended[:, :1]), ended[:, :-1]], 1) == 0


def _unk_penalised(lp):
    lp = lp.clone()
    lp[..., -1] -= 1000.0
    return lp


def decode_gap(lp, tokens, served_lp, rank, unk_penalty):
    """How far served captions are from the reference's decoder, in
    log-probability, over every position up to and including each
    caption's first token 0: the widest of (a) the gap between the
    log-probability served with a token and the reference's for it, and
    (b) the gap by which a served token lies below the ``rank``-th best of
    its position (1: greedy; the beam width: a beam's token is among the
    best ``rank`` of its own prefix's distribution).  lp [S, T, V+1] is
    teacher-forced on ``tokens`` [S, T]; ``served_lp`` [S, T];
    ``unk_penalty``: the beam search's -1000 on the unknown-word column."""
    if unk_penalty:
        lp = _unk_penalised(lp)
    kth = torch.topk(lp, rank, dim=-1).values[..., -1]
    ref = torch.gather(lp, 2, tokens[..., None])[..., 0]
    gap = torch.maximum((kth - ref).clamp(min=0), (served_lp - ref).abs())
    gap = torch.where(_served(tokens), gap, torch.zeros_like(gap))
    return float(gap.max()) if gap.numel() else 0.0


def beam_gap(lp, tokens, best, margin, tie):
    """How far served captions fall below the reference beam search's
    caption, in summed log-probability as the search scores it (the
    unknown word at -1000): the widest of ``best`` [S], the reference
    beam's summed log-probability, less the served caption's under lp
    [S, T, V+1], teacher-forced on ``tokens`` [S, T].  Rows whose search
    met a decision closer than ``tie`` (``margin`` [S], from :func:`beam`)
    are left out: a rounding may take the program down another branch
    there.  Returns (the gap, the rows judged)."""
    ref = torch.gather(_unk_penalised(lp), 2, tokens[..., None])[..., 0]
    served = torch.where(_served(tokens), ref, torch.zeros_like(ref)).sum(1)
    judged = margin >= tie
    gap = (best - served).clamp(min=0)[judged]
    return (float(gap.max()) if gap.numel() else 0.0), int(judged.sum())


def nms_keep(scores, mem, valid, thres, max_keep):
    """The reference's greedy NMS (``model.nms``), vectorised on the host:
    the kept indices in descending score order."""
    s = scores.detach().double().cpu().numpy()
    over = (M.pairwise_iou(mem) > thres).cpu().numpy()
    valid = valid.cpu().numpy().astype(bool)
    order = np.argsort(-np.where(valid, s, -np.inf), kind="stable")
    suppressed = np.zeros(len(s), bool)
    kept = []
    for i in order:
        if not valid[i] or len(kept) == max_keep:
            break
        if suppressed[i]:
            continue
        kept.append(int(i))
        suppressed |= over[i]
    return kept


def nms_gap(scores, mem, valid, keep, thres, max_keep):
    """How far ``keep``, a keep set to judge, is from greedy NMS under the
    reference's ``scores``: the least score margin e such that every valid
    sub-graph left out is either overlapped (IoU above ``thres``) by a kept
    one scoring at least its score less e, or, when ``keep`` is full,
    scores at most e above the lowest kept one.  1.0 where no margin can
    explain it: a kept pair that overlaps, a repeated, padded or
    out-of-range index, or more than ``max_keep`` kept."""
    s = scores.detach().double().cpu().numpy()
    over = (M.pairwise_iou(mem) > thres).cpu().numpy()
    valid = valid.cpu().numpy().astype(bool)
    keep = np.asarray(keep, np.int64)
    S = len(s)
    if (len(keep) > max_keep or len(set(keep.tolist())) != len(keep)
            or (keep < 0).any() or (keep >= S).any()
            or not valid[keep].all()):
        return 1.0
    if over[np.ix_(keep, keep)][~np.eye(len(keep), dtype=bool)].any():
        return 1.0
    kept = np.zeros(S, bool)
    kept[keep] = True
    left = np.nonzero(valid & ~kept)[0]
    if not len(left):
        return 0.0
    if len(keep):
        cover = np.where(over[np.ix_(keep, left)], s[keep][:, None], -np.inf)
        e_cover = s[left] - cover.max(0)
    else:
        e_cover = np.full(len(left), np.inf)
    e_trunc = (s[left] - s[keep].min() if len(keep) == max_keep
               else np.full(len(left), np.inf))
    e = np.minimum(e_cover, e_trunc).clip(min=0.0)
    return float(min(e.max(), 1.0))
