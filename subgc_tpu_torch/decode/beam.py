"""Beam search over a batch of sub-graphs (group_size 1).

The counterpart of ``subgc_tpu/decode/beam.py``.  Where the JAX package
vmaps a single-sub-graph search, every tensor here carries a leading
sub-graph axis S and a beam axis bdash, and the time loop is a Python loop.
Reference semantics kept (`models/CaptionModel.py:28-176`):

* UNK suppression: -1000 on the last vocab column before expansion
* optional decoding constraint: the previous word set to -inf
* t=0 expands only beam 0
* a beam finishes when it emits token 0 or at the last step; finished beams
  are recorded with the length penalty applied and their running sum is
  knocked to -1000
* the final pick sorts done beams by penalized score, ties to the earlier
  slot (``lax.top_k``'s order)

Ties in the expansion resolve (lower word, then lower beam), the JAX
package's word-major order: k ``torch.argmax`` passes (first index on ties)
over the column-major flattened candidate grid.  ``torch.topk`` is not used:
its tie order is unspecified.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import EvalConfig, ModelConfig
from ..models import decoder as D
from ..utils.penalty import penalty_fn


class BeamOut(NamedTuple):
    seq: torch.Tensor        # [S, T] best beam tokens
    logprobs: torch.Tensor   # [S, T] best beam per-token logprobs
    all_seqs: torch.Tensor   # [S, bdash, T] top done beams
    all_ps: torch.Tensor     # [S, bdash] their penalized scores


def _topk_small_wordmajor(cand, k: int):
    """Top-k over a [..., bdash, V1] grid with ties resolved (lower WORD,
    then lower beam).  Returns (values, beam, word), each [..., k]."""
    bdash, V1 = cand.shape[-2:]
    flat = cand.transpose(-1, -2).reshape(cand.shape[:-2] + (V1 * bdash,))
    flat = flat.clone()
    vals, qs, cs = [], [], []
    for _ in range(k):
        r = torch.argmax(flat, dim=-1, keepdim=True)   # first max on ties
        vals.append(torch.gather(flat, -1, r)[..., 0])
        qs.append((r % bdash)[..., 0])
        cs.append(torch.div(r, bdash, rounding_mode="floor")[..., 0])
        flat.scatter_(-1, r, float("-inf"))
    return torch.stack(vals, -1), torch.stack(qs, -1), torch.stack(cs, -1)


class _GroupState(NamedTuple):
    state: D.DecoderState       # [S, bdash, R]
    token: torch.Tensor         # [S, bdash] last chosen tokens
    beam_seq: torch.Tensor      # [S, bdash, T]
    beam_lps: torch.Tensor      # [S, bdash, T]
    beam_sum: torch.Tensor      # [S, bdash]
    done_seq: torch.Tensor      # [S, cap, T]
    done_lps: torch.Tensor      # [S, cap, T]
    done_p: torch.Tensor        # [S, cap]


def _init_group(S: int, bdash: int, cfg: ModelConfig, device) -> _GroupState:
    T = cfg.seq_length
    cap = bdash * T
    f = dict(dtype=torch.float32, device=device)
    i = dict(dtype=torch.int64, device=device)
    return _GroupState(
        state=D.init_state((S, bdash), cfg, device),
        token=torch.zeros((S, bdash), **i),            # BOS
        beam_seq=torch.zeros((S, bdash, T), **i),
        beam_lps=torch.zeros((S, bdash, T), **f),
        beam_sum=torch.zeros((S, bdash), **f),
        done_seq=torch.zeros((S, cap, T), **i),
        done_lps=torch.zeros((S, cap, T), **f),
        done_p=torch.full((S, cap), float("-inf"), **f))


def _expand_group(params, feats, gs: _GroupState, t: int, cfg: ModelConfig,
                  ecfg: EvalConfig, pen) -> _GroupState:
    """One beam step at time t: decode from the carried tokens, then expand."""
    S, bdash, T = gs.beam_seq.shape
    lp, state, _ = D.decode_step(params, gs.state, gs.token, feats, cfg)
    V1 = lp.shape[-1]

    logprobsf = lp
    if ecfg.decoding_constraint and t > 0:
        prev = gs.beam_seq[..., t - 1]
        hit = prev[..., None] == torch.arange(V1, device=lp.device)
        logprobsf = logprobsf.masked_fill(hit, float("-inf"))
    logprobsf[..., V1 - 1] += -1000.0        # in place: lp is not read again
    unaug = logprobsf

    cand = gs.beam_sum[..., None] + logprobsf
    if t == 0:
        cand[:, 1:] = float("-inf")
    vp, q, c = _topk_small_wordmajor(cand, bdash)            # [S, bdash]

    rows = torch.arange(S, device=lp.device)[:, None]
    new_seq = gs.beam_seq[rows, q]
    new_seq[..., t] = c
    new_lps = gs.beam_lps[rows, q]
    new_lps[..., t] = unaug[rows, q, c]
    state = D.DecoderState(*(x[rows, q] for x in state))
    beam_sum = vp

    is_done = (c == 0) | (t == T - 1)
    p_done = pen(t + 1, beam_sum)
    # this step's done slots; updated in place (gs is not read again)
    slot = slice(t * bdash, (t + 1) * bdash)
    done_seq, done_lps, done_p = gs.done_seq, gs.done_lps, gs.done_p
    done_seq[:, slot] = torch.where(is_done[..., None], new_seq,
                                    done_seq[:, slot])
    done_lps[:, slot] = torch.where(is_done[..., None], new_lps,
                                    done_lps[:, slot])
    done_p[:, slot] = torch.where(is_done, p_done,
                                  torch.full_like(p_done, float("-inf")))
    beam_sum = torch.where(is_done, torch.full_like(beam_sum, -1000.0),
                           beam_sum)
    return _GroupState(state=state, token=c, beam_seq=new_seq,
                       beam_lps=new_lps, beam_sum=beam_sum,
                       done_seq=done_seq, done_lps=done_lps, done_p=done_p)


def beam_search(params, feats: D.PreparedFeatures, cfg: ModelConfig,
                ecfg: EvalConfig) -> BeamOut:
    """Beam search for every sub-graph row of ``feats`` at once.

    Both beam attention layouts run (image-shared when ``feats.att_img`` is
    set, per-sub-graph otherwise); the beams of a row always share its
    features.  Diverse groups (group_size > 1) are not ported yet.
    """
    if ecfg.group_size != 1:
        raise NotImplementedError("diverse beam groups are not ported yet")
    D.require_float32(cfg)
    bdash = ecfg.beam_size
    S = feats.fc.shape[0]
    device = feats.fc.device
    if feats.att_img is not None:
        ai, pi = feats.att_img, feats.p_att_img
        if ai.dim() == 2:                       # single-image layout
            ai, pi = ai[None], pi[None]
        ii = feats.img_ix if feats.img_ix is not None \
            else torch.zeros((S,), dtype=torch.int64, device=device)
        feats = feats._replace(att_img=ai, p_att_img=pi, img_ix=ii)
    pen = penalty_fn(ecfg.length_penalty)

    gs = _init_group(S, bdash, cfg, device)
    for t in range(cfg.seq_length):
        gs = _expand_group(params, feats, gs, t, cfg, ecfg, pen)

    # stable descending sort = lax.top_k's pick (ties to the lower slot)
    top_i = torch.sort(gs.done_p, dim=-1, descending=True,
                       stable=True).indices[:, :bdash]
    rows = torch.arange(S, device=device)[:, None]
    all_seqs = gs.done_seq[rows, top_i]
    all_lps = gs.done_lps[rows, top_i]
    return BeamOut(seq=all_seqs[:, 0], logprobs=all_lps[:, 0],
                   all_seqs=all_seqs, all_ps=gs.done_p[rows, top_i])
