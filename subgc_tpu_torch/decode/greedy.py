"""Batched greedy / top-k sampling decode.

The counterpart of ``subgc_tpu/decode/greedy.py`` (reference
`models/AttModel.py:236-326`, ``_sample``): the sub-graph axis is batched and
the time loop runs to its fixed length with no early exit (finished
sequences are masked, which is numerically identical because outputs past
EOS are zeroed in both).

Semantics kept:

* greedy: argmax over the log-softmax vocab distribution (first index on
  ties);
* top-k sampling (AttModel.py:295-303): re-softmax at temperature
  ``topk_temp``, keep exactly the ``the_k`` largest (ties to the lowest
  index), draw; the recorded logprob is the un-renormalised tempered
  log-softmax value at the drawn token;
* "unfinished" latching: the first EOS (token 0) zeroes the rest of the
  sequence;
* attention weights [S, T+1, N] under ``return_att`` (the grounding
  contract, grd_utils.py:13-61; the extra step runs only then), else the
  [S, T, N] rows the decode computed.

Draws take an explicit ``torch.Generator`` on the tensors' device.  Torch
cannot reproduce jax's PRNG draws, so top-k matches the JAX package in its
selection rule and its masked distribution, not in the tokens drawn.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import EvalConfig, ModelConfig
from ..models import decoder as D
from ..utils.profiling import span


def _topk_mask(lp2: torch.Tensor, k: int) -> torch.Tensor:
    """Keep EXACTLY the k largest entries per row (others -> -inf) by k
    argmax-and-mask passes; ties go to the lowest index, as in the JAX
    package.  ``torch.topk`` is not used: its pick among tied entries
    differs between the CPU and CUDA builds."""
    work = lp2.clone()
    keep = torch.zeros_like(lp2, dtype=torch.bool)
    for _ in range(k):
        idx = torch.argmax(work, dim=-1, keepdim=True)     # first max on ties
        keep.scatter_(-1, idx, True)
        work.scatter_(-1, idx, float("-inf"))
    return torch.where(keep, lp2, torch.full_like(lp2, float("-inf")))


class SampleOut(NamedTuple):
    seq: torch.Tensor           # [S, T] int64
    logprobs: torch.Tensor      # [S, T] logprob of each chosen token
    att_weights: torch.Tensor   # [S, T+1, N] under return_att, else [S, T, N]


@torch.no_grad()
def sample(params, feats: D.PreparedFeatures, cfg: ModelConfig,
           ecfg: EvalConfig,
           generator: Optional[torch.Generator] = None,
           rows=None) -> SampleOut:
    """Greedy (or top-k) decode of every row of ``feats`` at once.

    Both per-row attention layouts run: the image-shared fan-out when
    ``feats.att_img`` is set, the per-row streams otherwise (attention
    capture).  ``generator`` feeds the top-k draws; without one, a generator
    seeded with 0 on the tensors' device is used.  ``rows=(at, total)``:
    these rows are rows ``at ..`` (an int), or rows ``at`` (an index
    tensor), of a ``total``-row decode (a shard of a sharded decode, the
    kept rows of a keep set), whose draws they take
    (``decoder.draw_categorical``), so that the sampled tokens depend on
    neither the shard count nor the rows left out.  Runs without
    autograd, so params that require grad decode as their detached copies
    do.
    """
    with span("subgc.decode"):
        params = D.cast_decoder_weights(params, cfg)     # once per call
        split = D.SplitWeights()     # the split route's weights, once a call
        S = feats.fc.shape[0]
        T = cfg.seq_length
        dev = feats.fc.device
        if ecfg.use_topk_sampling and generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)

        state = D.init_state(S, cfg, dev)
        it = torch.zeros((S,), dtype=torch.int64, device=dev)
        unfinished = torch.ones((S,), dtype=torch.bool, device=dev)
        seqs, lps, atts = [], [], []
        # the final (T-th) step only contributes its attention weights, so it
        # runs only when the caller captures them
        for t in range(T + 1 if ecfg.return_att else T):
            with span("subgc.decode.step"):
                lp, state, att_w = D.decode_step(params, state, it, feats,
                                                 cfg, split=split)
            if ecfg.use_topk_sampling:
                lp2 = torch.log_softmax(lp / ecfg.topk_temp, dim=-1)
                nxt = D.draw_categorical(_topk_mask(lp2, ecfg.the_k),
                                         generator, rows)
                chosen = torch.gather(lp2, 1, nxt[:, None])[:, 0]
            else:
                nxt = torch.argmax(lp, dim=-1)
                chosen = torch.gather(lp, 1, nxt[:, None])[:, 0]
            unfinished = (nxt > 0) if t == 0 else unfinished & (nxt > 0)
            it = nxt * unfinished
            seqs.append(it)
            lps.append(chosen)
            atts.append(att_w)
        return SampleOut(seq=torch.stack(seqs[:T], 1),
                         logprobs=torch.stack(lps[:T], 1),
                         att_weights=torch.stack(atts, 1))
