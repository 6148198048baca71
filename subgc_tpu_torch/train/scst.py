"""Self-critical sequence training (SCST); the counterpart of
``subgc_tpu/train/scst.py``.

The reference ships `RewardCriterion` (misc/utils.py:89-109) and a
`self_critical_after` flag (opts.py:66) but never enables them in the
shipped configs; the JAX package's pipeline, step for step:

1. one dispatch without autograd decodes, from each sentence's sub-graph
   features, the greedy baseline and a multinomial sample (draws from an
   explicit ``torch.Generator``); the features are per sentence, so on the
   card the attention is the per-row kernel (``row_attention``);
2. the host scores both against the image's GT captions with the port's
   CIDEr: reward = CIDEr(sample) - CIDEr(greedy);
3. the update recomputes the sample's logprobs under autograd
   (``decode_step`` on the sampled tokens, attending through
   ``attention_teacher``: the kernels are forward-only), applies the
   policy-gradient ``reward_loss`` and the clipped optimizer step at the
   scheduled learning rate.

It runs in float32 and in the bf16 chain (``cfg.compute_dtype``,
``bf16_lstm_gates``), as the JAX step does with its config.

Under a data-parallel process group (``group``) each rank decodes its
slice of the batch, drawing the global batch's uniforms and keeping its
rows; the host gathers every rank's greedy and sampled sequences, scores
the *global* batch (CIDEr's document frequencies are the batch's, as the
JAX step scores its gathered global samples) on every rank, and each rank
keeps its own rows' rewards.  The update normalises by the global mask
count and sums the gradients over the ranks.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig
from ..eval.cider import compute_cider
from ..models import decoder as D
from ..models import encoder as E
from ..models import gpn as G
from ..models import subgc
from ..parallel import distributed as DP
from ..utils.text import decode_sequence
from . import optim
from .loss import reward_loss
from .step import TrainBatch, TrainState


def _prepare_sentence_feats(params, state, batch: TrainBatch,
                            cfg: ModelConfig) -> D.PreparedFeatures:
    """Encoder + sGPN train branch (eval mode) -> features per sentence
    (JAX ``scst.py:36-51``): each sentence's best-scoring positive
    sub-graph, or under Full-GC every node of its image with the mean
    read-out (not detached here, as in the JAX function)."""
    x_obj, _, _ = E.encode_graph(params, state, batch.graph, cfg, train=False)
    if cfg.use_gpn:
        _, _, att_feats, fc_feats, att_masks, _ = G.gpn_train_forward(
            params, x_obj, batch.sub_obj_ind, batch.sub_att_mask,
            batch.img_ix, cfg, train=False)
    else:
        att_feats = x_obj[batch.img_ix]
        fc_feats = subgc._full_graph_readout(params, att_feats.mean(1))
        att_masks = subgc._full_graph_mask(att_feats.shape[0], cfg,
                                           x_obj.device)
    feats, _ = D.prepare_features_bn(params, fc_feats, att_feats, att_masks,
                                     cfg, bn_state=state.get("att_bn"))
    return feats


def _rollout(params, feats: D.PreparedFeatures, cfg: ModelConfig,
             generator=None):
    """seq_length decode steps from BOS: the argmax (``generator`` None) or
    a categorical draw per row.  A row is finished from its first EOS on:
    its later tokens are 0 (JAX ``scst.py:61-78``).  Returns (tokens
    [S, T] int64, the chosen tokens' logprobs [S, T], taken before the
    masking)."""
    S = feats.fc.shape[0]
    dev = feats.fc.device
    st = D.init_state(S, cfg, dev)
    it = torch.zeros((S,), dtype=torch.int64, device=dev)
    unfinished = torch.ones((S,), dtype=torch.bool, device=dev)
    split = D.SplitWeights()
    seq, lps = [], []
    for t in range(cfg.seq_length):
        lp, st, _ = D.decode_step(params, st, it, feats, cfg, split=split)
        nxt = (lp.argmax(-1) if generator is None
               else D.draw_categorical(lp, generator))
        lps.append(lp.gather(1, nxt[:, None])[:, 0])
        unfinished = nxt > 0 if t == 0 else unfinished & (nxt > 0)
        it = nxt * unfinished
        seq.append(it)
    return torch.stack(seq, 1), torch.stack(lps, 1)


def make_sample_fn(cfg: ModelConfig, group=None):
    """One dispatch without autograd: sample(params, state, batch,
    generator) -> (greedy tokens, sampled tokens, the sample's logprobs),
    each [S, T] on the batch's device.  ``group``: the draws are the
    global batch's, cut to this rank's rows."""

    @torch.no_grad()
    def sample(params, state, batch: TrainBatch, generator):
        p = D.cast_decoder_weights(params, cfg)
        feats = _prepare_sentence_feats(p, state, batch, cfg)
        greedy_seq, _ = _rollout(p, feats, cfg)
        with DP.data_parallel(group):
            sample_seq, sample_lps = _rollout(p, feats, cfg, generator)
        return greedy_seq, sample_seq, sample_lps

    return sample


def compute_rewards(greedy_seq: np.ndarray, sample_seq: np.ndarray,
                    gts_tokens: List[np.ndarray], vocab) -> np.ndarray:
    """reward[s] = CIDEr(sample_s) - CIDEr(greedy_s) vs its image's GTs."""
    S = sample_seq.shape[0]
    greedy_sents = decode_sequence(vocab, greedy_seq, remove_bad_endings=False)
    sample_sents = decode_sequence(vocab, sample_seq, remove_bad_endings=False)
    refs = [decode_sequence(vocab, gts_tokens[s], remove_bad_endings=False)
            for s in range(S)]
    gts = {s: refs[s] for s in range(S)}
    gts.update({S + s: refs[s] for s in range(S)})
    res = {s: [sample_sents[s] or "a"] for s in range(S)}
    res.update({S + s: [greedy_sents[s] or "a"] for s in range(S)})
    _, scores = compute_cider(gts, res)
    return (scores[:S] - scores[S:]).astype(np.float32)


def sample_logprobs(params, state, batch: TrainBatch, sample_seq,
                    cfg: ModelConfig):
    """The logprobs [S, T] of ``sample_seq``'s tokens under ``params``,
    teacher-forced on the sampled tokens: under autograd when ``params``
    require grad (attention through ``attention_teacher``)."""
    p = D.cast_decoder_weights(params, cfg)
    feats = _prepare_sentence_feats(p, state, batch, cfg)
    S, T = sample_seq.shape
    st = D.init_state(S, cfg, sample_seq.device)
    it = torch.zeros((S,), dtype=torch.int64, device=sample_seq.device)
    split = D.SplitWeights()
    lps = []
    for t in range(T):
        lp, st, _ = D.decode_step(p, st, it, feats, cfg, split=split)
        it = sample_seq[:, t]
        lps.append(lp.gather(1, it[:, None])[:, 0])
    return torch.stack(lps, 1)


def scst_loss(params, state, batch: TrainBatch, sample_seq, rewards,
              cfg: ModelConfig):
    """RewardCriterion at the sampled sequences, each sentence's reward
    [S] on every one of its steps (JAX ``scst.py:107-122``)."""
    lps = sample_logprobs(params, state, batch, sample_seq, cfg)
    return reward_loss(lps, sample_seq, rewards[:, None].expand_as(lps))


def make_scst_update_fn(cfg: ModelConfig, tcfg: TrainConfig, group=None):
    """The second dispatch: update(ts, batch, sample_seq, rewards, epoch)
    -> (ts, loss as a 0-d tensor).  The gradient of :func:`scst_loss`, then
    the clipped step of ``tcfg.optim`` at ``learning_rate(ts.step,
    epoch)``, in place on the params.  ``group``: the loss and the
    gradients are the global batch's."""

    def update(ts: TrainState, batch: TrainBatch, sample_seq, rewards,
               epoch: int):
        with DP.data_parallel(group):
            loss = scst_loss(ts.params, ts.model_state, batch, sample_seq,
                             rewards, cfg)
        leaves = optim.tree_leaves(ts.params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        if group is not None:
            grads = DP.all_reduce_gradients(grads, leaves, group)
            loss = loss.detach().clone()
            torch.distributed.all_reduce(loss, group=group)
        lr = optim.learning_rate(ts.step, epoch, tcfg)
        opt_state, _ = optim.apply_update(ts.params, grads, ts.opt_state, lr,
                                          tcfg)
        return TrainState(ts.params, ts.model_state, opt_state,
                          ts.step + 1), loss.detach()

    return update


def scst_train_step(ts: TrainState, batch: TrainBatch, gts_tokens, vocab,
                    sample_fn, update_fn, generator, epoch: int, group=None):
    """Full SCST iteration (two dispatches + host reward).  Returns (ts,
    loss, mean reward) with the two numbers on the host.

    ``group``: ``batch`` is this rank's slice, ``gts_tokens`` the global
    batch's (one entry per global sentence), and the functions were made
    with the same group; the rewards are scored over the gathered global
    batch and the numbers returned are the global ones."""
    greedy_seq, sample_seq, _ = sample_fn(ts.params, ts.model_state, batch,
                                          generator)
    greedy_np, sample_np = greedy_seq.cpu().numpy(), sample_seq.cpu().numpy()
    lo, S = 0, len(sample_np)
    if group is not None:
        greedy_all = DP.all_gather_arrays(greedy_np, group)
        sample_all = DP.all_gather_arrays(sample_np, group)
        lo = sum(len(x) for x in sample_all[:DP.get_process_index(group)])
        greedy_np = np.concatenate(greedy_all)
        sample_np = np.concatenate(sample_all)
    rewards = compute_rewards(greedy_np, sample_np, gts_tokens, vocab)
    ts, loss = update_fn(ts, batch, sample_seq,
                         torch.from_numpy(rewards[lo:lo + S]).to(
                             sample_seq.device), epoch)
    return ts, float(loss), float(rewards.mean())
