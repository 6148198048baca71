"""(Diverse) beam search over a batch of sub-graphs.

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
* diverse groups (``group_size`` G > 1, ``bdash = beam_size // G`` beams
  each): the groups run staggered over T + G - 1 outer steps, group g at
  local time ``t - g``, in ascending order; group g subtracts
  ``diversity_lambda`` once per occurrence of each token that groups < g
  chose at its local time, read from their rows as this outer step left
  them (updated and re-permuted); stored per-token logprobs are the
  unaugmented ones; the output concatenates each group's top-bdash list,
  so ``seq`` is group 0's best.  The JAX package runs a masked expand for
  the inactive groups of an outer step and discards it; here only the
  active groups decode, G x T steps in all, with the same tokens.

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
from ..utils.profiling import span
from . import graphs


class BeamOut(NamedTuple):
    seq: torch.Tensor        # [S, T] best beam tokens
    logprobs: torch.Tensor   # [S, T] best beam per-token logprobs
    all_seqs: torch.Tensor   # [S, G*bdash, T] each group's top done beams
    all_ps: torch.Tensor     # [S, G*bdash] their penalized scores


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
                  ecfg: EvalConfig, pen, diversity_tokens=None,
                  split=None) -> _GroupState:
    """One beam step at local time t: decode from the carried tokens, then
    expand.  ``diversity_tokens`` [S, n]: the tokens earlier groups chose at
    this local time; each occurrence subtracts ``diversity_lambda``.
    ``split``: the search's ``decoder.SplitWeights``."""
    S, bdash, T = gs.beam_seq.shape
    with span("subgc.decode.step"):
        lp, state, _ = D.decode_step(params, gs.state, gs.token, feats, cfg,
                                     split=split)
    V1 = lp.shape[-1]

    logprobsf = lp
    if ecfg.decoding_constraint and t > 0:
        prev = gs.beam_seq[..., t - 1]
        hit = prev[..., None] == torch.arange(V1, device=lp.device)
        logprobsf = logprobsf.masked_fill(hit, float("-inf"))
    logprobsf[..., V1 - 1] += -1000.0        # in place: lp is not read again
    unaug = logprobsf
    if diversity_tokens is not None:
        # a float32 one-hot sum: a token chosen twice counts twice
        counts = torch.zeros((S, V1), dtype=torch.float32, device=lp.device)
        counts.scatter_add_(1, diversity_tokens,
                            torch.ones_like(diversity_tokens,
                                            dtype=torch.float32))
        logprobsf = logprobsf - ecfg.diversity_lambda * counts[:, None, :]

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


def _top_done(gs: _GroupState, bdash: int):
    """(seqs, lps, ps) of a group's top-bdash done beams; a stable
    descending sort is ``lax.top_k``'s pick (ties to the lower slot)."""
    top_i = torch.sort(gs.done_p, dim=-1, descending=True,
                       stable=True).indices[:, :bdash]
    rows = torch.arange(top_i.shape[0], device=top_i.device)[:, None]
    return (gs.done_seq[rows, top_i], gs.done_lps[rows, top_i],
            gs.done_p[rows, top_i])


def _search(params, feats: D.PreparedFeatures, cfg: ModelConfig,
            ecfg: EvalConfig):
    """:func:`beam_search`'s body as a generator: it yields after each
    outer step and returns the :class:`BeamOut`.  ``graphs.py`` runs it to
    its end, or captures each stretch between two yields as a CUDA graph;
    whatever the search derives from ``params`` and ``feats`` is derived
    inside it, so a replay derives it again."""
    G = ecfg.group_size
    params = D.cast_decoder_weights(params, cfg)     # once per call
    split = D.SplitWeights()     # the split route's weights, once a call
    bdash = ecfg.beam_size // G
    T = cfg.seq_length
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

    groups = [_init_group(S, bdash, cfg, device) for _ in range(G)]
    # outer step t: group g is active at local time t - g in [0, T); the
    # groups update in ascending order, so group g reads groups < g as this
    # step left them (CaptionModel.py:122-171)
    for t in range(T + G - 1):
        for g in range(max(0, t - T + 1), min(G, t + 1)):
            lt = t - g
            div = torch.cat([groups[pg].beam_seq[..., lt]
                             for pg in range(g)], dim=-1) if g else None
            groups[g] = _expand_group(params, feats, groups[g], lt, cfg,
                                      ecfg, pen, diversity_tokens=div,
                                      split=split)
        yield

    seqs, lps, ps = zip(*(_top_done(gs, bdash) for gs in groups))
    all_seqs, all_lps = torch.cat(seqs, 1), torch.cat(lps, 1)
    return BeamOut(seq=all_seqs[:, 0], logprobs=all_lps[:, 0],
                   all_seqs=all_seqs, all_ps=torch.cat(ps, 1))


@torch.no_grad()
def beam_search(params, feats: D.PreparedFeatures, cfg: ModelConfig,
                ecfg: EvalConfig) -> BeamOut:
    """Beam search for every sub-graph row of ``feats`` at once, in
    ``ecfg.group_size`` diverse groups.

    Both beam attention layouts run (image-shared when ``feats.att_img`` is
    set, per-sub-graph otherwise); the beams of a group always share their
    row's features, so each decode step launches the beam-shared attention
    once at B = bdash.  Runs without autograd, so params that require grad
    decode as their detached copies do.

    On the card a search whose key (``graphs.py``) was seen before replays
    from captured CUDA graphs, one an outer step, with the same kernels and
    the same bits as the eager search; its outputs are the caller's own.
    """
    G = ecfg.group_size
    if G < 1 or ecfg.beam_size % G:
        raise ValueError(f"beam_size {ecfg.beam_size} must be a multiple of "
                         f"group_size {G}")
    with span("subgc.decode"):
        return graphs.SEARCHES.run(_search, params, feats, cfg, ecfg)
