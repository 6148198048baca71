"""Test-split inference orchestration -> captions_*.npy artifacts.

The counterpart of ``subgc_tpu/eval/runner.py`` (reference
`misc/eval_utils.py:87-172`): for each image batch, encode the scene graphs,
score and NMS the sub-graphs, decode one caption per kept sub-graph (beam
search, or greedy / top-k sampling at ``beam_size`` 1), sort the captions by
sGPN score (under SCT keep the region sets' order), and write the
predictions in the reference's format:

    captions_<iter>.npy  — list of {image_id, caption: [str],
                           subgraph_score: np[K], sorted_subgraph_ind: np[K]}

(``ctl_captions_<iter>.npy`` under SCT).  Under ``return_att`` the greedy
decode's attention weights go to a ``collect_grounding`` callback
(``eval/grounding.py::GroundingCollector``).  Mesh sharding is not ported
yet.
"""
from __future__ import annotations

import os
import time
from typing import List

import numpy as np
import torch

from ..config import EvalConfig, ModelConfig
from ..decode import beam as beam_mod
from ..decode import greedy as greedy_mod
from ..device import f32_accumulation, resolve_device
from ..graph import SceneGraph, SubgraphSet, to_device
from ..models import subgc
from ..utils.text import decode_sequence


def make_batched_infer_fn(cfg: ModelConfig, ecfg: EvalConfig):
    """[B]-image program: graph [B, ...] and subs [B, S, ...] tensors in,
    a dict of [B, Smax, ...] tensors out (seq, logprobs, scores, keep_ind,
    keep_valid; att_weights under ``return_att``; every beam's tokens,
    all_beams, under ``verbose_beam``).  ``generator`` feeds the top-k
    draws."""

    @torch.no_grad()
    def infer(params, state, graph, subs, generator=None):
        enc = subgc.encode_images_batched(params, state, graph, subs, cfg,
                                          ecfg)
        if ecfg.beam_size > 1:
            out = beam_mod.beam_search(params, enc.feats, cfg, ecfg)
        else:
            out = greedy_mod.sample(params, enc.feats, cfg, ecfg, generator)
        res = dict(seq=out.seq, logprobs=out.logprobs, scores=enc.scores,
                   keep_ind=enc.keep_ind, keep_valid=enc.keep_valid)
        if ecfg.beam_size <= 1 and ecfg.return_att:
            res["att_weights"] = out.att_weights
        if ecfg.beam_size > 1 and ecfg.verbose_beam:
            res["all_beams"] = out.all_seqs
        B = graph.obj_fmap.shape[0]
        return {k: v.reshape((B, -1) + v.shape[1:]) for k, v in res.items()}

    return infer


def _stack_examples(examples):
    graph = SceneGraph(*[np.concatenate([getattr(e.graph, f) for e in examples])
                         for f in SceneGraph._fields])
    subs = SubgraphSet(*[np.stack([getattr(e.subs, f) for e in examples])
                         for f in SubgraphSet._fields])
    return graph, subs


@f32_accumulation()
def run_test_split(params, state, loader, cfg: ModelConfig, ecfg: EvalConfig,
                   vocab, split: str = "test", num_images: int = -1,
                   verbose: bool = True, batch_images: int = 16,
                   keep_tokens: bool = False, device="cuda",
                   collect_grounding=None):
    """Decode the split on ``device``.  Returns (predictions, wall_seconds,
    n_captions).

    ``loader`` is anything with ``iter_split(split, num_images)`` yielding
    ``TestExample``s (``data.dataset.EvalLoader``, ``data.sct.SCTLoader``);
    ``params`` and ``state`` must already lie on ``device``.  Full-GC
    (``use_gpn=False``) raises: it has no batched route, in the JAX runner
    either, and decodes through ``models.subgc.encode_image``.

    collect_grounding: optional callback(example, sents, sorted_ind,
    att_weights, order) for the grounding path (grd_utils.py:13-61);
    att_weights is None unless ``ecfg.return_att``.

    Top-k draws come from one generator on ``device`` for the whole split,
    seeded with 2019 as the JAX package's default key is.  bfloat16 matmuls
    sum in float32 throughout (``device.f32_accumulation``).
    """
    if not cfg.use_gpn:
        raise ValueError(
            "run_test_split decodes Sub-GC models only: Full-GC "
            "(use_gpn=False) has no batched route, in the JAX package's "
            "runner either; decode it per image with encode_image + "
            "beam_search")
    dev = resolve_device(device)
    infer = make_batched_infer_fn(cfg, ecfg)
    generator = torch.Generator(device=dev).manual_seed(2019)
    examples = list(loader.iter_split(split, num_images))
    if not examples:
        return [], 0.0, 0

    t0 = time.time()
    predictions: List[dict] = []
    n_caps = 0
    # seeded locally, as in the JAX runner: the print-out is reproducible
    # and the global numpy stream is left alone
    vb_rng = np.random.RandomState(2019) if ecfg.verbose_beam else None
    for i in range(0, len(examples), batch_images):
        chunk = examples[i:i + batch_images]
        # fixed-size image batches (the last one padded by repetition)
        padded = chunk + [chunk[-1]] * (batch_images - len(chunk))
        graph, subs = _stack_examples(padded)
        out = infer(params, state, to_device(graph, dev),
                    to_device(subs, dev), generator)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        for bi, ex in enumerate(chunk):
            n = int(out["keep_valid"][bi].sum())
            seq = out["seq"][bi][:n]
            scores = out["scores"][bi][:n]
            keep_ind = out["keep_ind"][bi][:n]
            if ecfg.sct:
                # SCT keeps the region sets' order (eval_utils.py:115-120)
                order = np.arange(n)
            else:
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
            if collect_grounding is not None:
                att = out.get("att_weights")
                collect_grounding(ex, sents, keep_ind[order],
                                  att[bi][:n][order] if att is not None
                                  else None, order)
            if vb_rng is not None and "all_beams" in out and n:
                # one random kept sub-graph's beams per image
                # (eval_utils.py:124-130)
                pick = int(vb_rng.choice(n))
                beams = decode_sequence(
                    vocab, out["all_beams"][bi][pick],
                    remove_bad_endings=ecfg.remove_bad_endings)
                print(f"beam search sentences of image {ex.info.id} "
                      f"(sub-graph {int(out['keep_ind'][bi][pick])}):")
                print("\n".join(beams))
                print("--" * 10)
            if verbose and len(predictions) <= 3:
                print(f"image {ex.info.id}: kept {n} sub-graphs; best: "
                      f"{sents[0] if sents else '<none>'!r}")
    return predictions, time.time() - t0, n_caps


def save_predictions(predictions, out_dir: str, iter_tag: str,
                     sct: bool = False) -> str:
    """Write ``captions_<iter_tag>.npy`` (``ctl_captions_<iter_tag>.npy``
    under SCT) in ``out_dir``; returns its path."""
    os.makedirs(out_dir, exist_ok=True)
    name = "ctl_captions_{}.npy" if sct else "captions_{}.npy"
    path = os.path.join(out_dir, name.format(iter_tag))
    np.save(path, np.asarray(predictions, dtype=object), allow_pickle=True)
    return path
