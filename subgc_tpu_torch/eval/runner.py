"""Test-split inference orchestration -> captions_*.npy artifacts.

The beam path of ``subgc_tpu/eval/runner.py`` (reference
`misc/eval_utils.py:87-172`): for each image batch, encode the scene graphs,
score and NMS the sub-graphs, beam-decode one caption per kept sub-graph,
sort the captions by sGPN score, and write the predictions in the
reference's format:

    captions_<iter>.npy  — list of {image_id, caption: [str],
                           subgraph_score: np[K], sorted_subgraph_ind: np[K]}

Greedy and top-k decoding, mesh sharding, grounding and the verbose beam
print-out are not ported yet.
"""
from __future__ import annotations

import os
import time
from typing import List

import numpy as np
import torch

from ..config import EvalConfig, ModelConfig
from ..decode import beam as beam_mod
from ..device import resolve_device
from ..graph import SceneGraph, SubgraphSet, to_device
from ..models import subgc
from ..utils.text import decode_sequence


def make_batched_infer_fn(cfg: ModelConfig, ecfg: EvalConfig):
    """[B]-image program: graph [B, ...] and subs [B, S, ...] tensors in,
    a dict of [B, Smax, ...] tensors out (seq, logprobs, scores, keep_ind,
    keep_valid)."""
    if ecfg.beam_size <= 1:
        raise NotImplementedError("greedy and top-k decoding are not ported "
                                  "yet; the port runs beam search")
    if ecfg.return_att:
        raise NotImplementedError("attention capture (grounding) is not "
                                  "ported yet")

    @torch.no_grad()
    def infer(params, state, graph, subs):
        enc = subgc.encode_images_batched(params, state, graph, subs, cfg,
                                          ecfg)
        out = beam_mod.beam_search(params, enc.feats, cfg, ecfg)
        res = dict(seq=out.seq, logprobs=out.logprobs, scores=enc.scores,
                   keep_ind=enc.keep_ind, keep_valid=enc.keep_valid)
        B = graph.obj_fmap.shape[0]
        return {k: v.reshape((B, -1) + v.shape[1:]) for k, v in res.items()}

    return infer


def _stack_examples(examples):
    graph = SceneGraph(*[np.concatenate([getattr(e.graph, f) for e in examples])
                         for f in SceneGraph._fields])
    subs = SubgraphSet(*[np.stack([getattr(e.subs, f) for e in examples])
                         for f in SubgraphSet._fields])
    return graph, subs


def run_test_split(params, state, loader, cfg: ModelConfig, ecfg: EvalConfig,
                   vocab, split: str = "test", num_images: int = -1,
                   verbose: bool = True, batch_images: int = 16,
                   keep_tokens: bool = False, device="cuda"):
    """Decode the split on ``device``.  Returns (predictions, wall_seconds,
    n_captions).

    ``loader`` is anything with ``iter_split(split, num_images)`` yielding
    ``TestExample``s (``data.dataset.EvalLoader``); ``params`` must already
    lie on ``device``.
    """
    dev = resolve_device(device)
    infer = make_batched_infer_fn(cfg, ecfg)
    examples = list(loader.iter_split(split, num_images))
    if not examples:
        return [], 0.0, 0

    t0 = time.time()
    predictions: List[dict] = []
    n_caps = 0
    for i in range(0, len(examples), batch_images):
        chunk = examples[i:i + batch_images]
        # fixed-size image batches (the last one padded by repetition)
        padded = chunk + [chunk[-1]] * (batch_images - len(chunk))
        graph, subs = _stack_examples(padded)
        out = infer(params, state, to_device(graph, dev),
                    to_device(subs, dev))
        out = {k: v.cpu().numpy() for k, v in out.items()}
        for bi, ex in enumerate(chunk):
            n = int(out["keep_valid"][bi].sum())
            seq = out["seq"][bi][:n]
            scores = out["scores"][bi][:n]
            keep_ind = out["keep_ind"][bi][:n]
            # sort captions by sGPN score desc (eval_utils.py:105-114)
            order = np.argsort(-scores, kind="stable")
            sents = decode_sequence(vocab, seq[order],
                                    remove_bad_endings=ecfg.remove_bad_endings)
            pred = {
                "image_id": ex.info.id,
                "caption": sents,
                "subgraph_score": scores[order],
                "sorted_subgraph_ind": keep_ind[order],
            }
            if keep_tokens:
                pred["tokens"] = seq[order]
            predictions.append(pred)
            n_caps += len(sents)
            if verbose and len(predictions) <= 3:
                print(f"image {ex.info.id}: kept {n} sub-graphs; best: "
                      f"{sents[0] if sents else '<none>'!r}")
    return predictions, time.time() - t0, n_caps


def save_predictions(predictions, out_dir: str, iter_tag: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"captions_{iter_tag}.npy")
    np.save(path, np.asarray(predictions, dtype=object), allow_pickle=True)
    return path
