"""Test-split decoding: ``subgc_tpu_torch.eval.runner.run_test_split`` as
``cli/test.py`` calls it, over a seeded in-memory split, again and again
until the window closes.

The mix (``portbench/traffic/<mix>.json``) gives the decode settings
(``eval``: the test preset's beam, NMS threshold and keep), the images a
dispatch (``batch_images``), the sub-graph bucket, the sub-graphs sampled
an image, and the detections and relations of each scene graph.  The split
holds ``POOL_DISPATCHES`` distinct dispatches.

End to end: ``captions_per_s``, captions completed over the whole window,
host work included.  The traced run profiles its first
``PROFILE_SECONDS`` as the untraced window runs, then spans the encoder
(sGPN and NMS included) and the decode, synchronised, over the rest.

Output check, once the window has closed, against ``portbench/reference``
in float32 with TF32 off, on weights it makes again from the seed.  For
each of ``CHECK_SLOTS`` images drawn from the seed the window keeps one
of its calls' answers, drawn from the seed as the calls come (a reservoir
of one), and it keeps the last call's; the check reads, in the seed's
order, at least ``CHECK_IMAGES`` of the kept images and more until they
hold ``CHECK_CAPTIONS`` captions, and the one of the last call's longest
caption.  It reads what the runner returns (keep sets, scores, captions)
and the per-token log-probabilities the decode returned to the runner
(kept by a wrapper of ``eval/runner.py::_decode`` without a copy):

* ``sgpn_gap``: the widest of the gaps between a kept sub-graph's sGPN
  score and the reference's, and the score margin the keep set needs to be
  the reference's greedy NMS (``reference.decode.nms_gap``);
* ``decode_gap``: the widest of the gaps between a served token's
  log-probability and the reference's, and of the gap by which a served
  token lies below the reference's best (greedy) or beam-width-th best
  (beam) at its position, fed the caption's own tokens
  (``reference.decode.decode_gap``);
* ``beam_gap`` (beam search only): how far a served caption's summed
  log-probability falls below the reference beam search's caption's
  (``reference.decode.beam_gap``), over the captions whose reference
  search met no decision closer than ``BEAM_TIE``.
"""
from __future__ import annotations

import gc
import os
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np
import torch

from .. import weights as W
from ..harness import Reading
from ..metrics import counts
from ..reference import decode as D
from ..reference import model as M
from ..traffic import sampler
from . import model_config
from .spans import Spans, profiled

GRAPH_KEYS = ("obj_fmap", "obj_dist", "rel_ind", "pred_dist")
POOL_DISPATCHES = 3     # distinct dispatches in the split
PROFILE_SECONDS = 2.0   # the traced run's profiled part
CHECK_SLOTS = 16        # images whose answers the window keeps
CHECK_IMAGES = 3        # images the check reads at least ...
CHECK_CAPTIONS = 80     # ... and more until their captions are this many
BEAM_TIE = 1e-4         # closer decisions of the reference beam: not judged


def make_split(seed, cfg, tr):
    n = tr["batch_images"] * POOL_DISPATCHES
    jobs = [(seed, i, cfg, tr) for i in range(n)]
    workers = min(8, os.cpu_count() or 1)
    if workers < 2 or n < 16:
        return [sampler.test_image(j) for j in jobs]
    # the workers import numpy and the sampler only
    with ProcessPoolExecutor(workers, mp_context=get_context("spawn")) as ex:
        return list(ex.map(sampler.test_image, jobs))


class _Split:
    """The runner's loader contract over in-memory examples."""

    def __init__(self, examples):
        self.examples = examples

    def iter_split(self, split="test", num_images=-1):
        return iter(self.examples)


def _tokens(captions, T):
    """Captions of words ``w<id>`` back to [K, T] token ids (0 after the
    end)."""
    out = np.zeros((len(captions), T), np.int64)
    for i, c in enumerate(captions):
        ids = [int(x[1:]) for x in c.split()]
        out[i, :len(ids)] = ids
    return out


def _image_tensors(image, dev):
    graph, subs, _ = image
    g = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
         for k, v in zip(GRAPH_KEYS, graph)}
    g["rel_ind"] = g["rel_ind"].long()
    obj_ind, _, att_mask, valid = (torch.from_numpy(x).to(dev) for x in subs)
    return g, obj_ind.long(), att_mask, valid


def _score(w, st, cfg, image, dev):
    g, obj_ind, att_mask, valid = _image_tensors(image, dev)
    x_obj, _ = M.encode(w, st, cfg, g)
    scores, read_out, mem = D.score_subgraphs(w, cfg, x_obj[0], obj_ind,
                                              att_mask)
    return x_obj[0], obj_ind, att_mask, valid, scores, read_out, mem


def serve_reference(w, st, cfg, ecfg, image, dev, search=None):
    """The test path computed by the reference itself: its keep set, the
    kept sub-graphs' scores, their captions and the captions' per-token
    log-probabilities (the control puts this in the program's place).
    ``search`` plants a fault of ``control.py`` in a beam search:
    ``"greedy"`` decodes greedily instead, ``"second"`` serves the second
    best done beam."""
    x, obj_ind, att_mask, valid, scores, read_out, mem = _score(
        w, st, cfg, image, dev)
    keep = D.nms_keep(scores, mem, valid, ecfg["gpn_nms_thres"],
                      ecfg["gpn_max_subg"])
    k = torch.as_tensor(keep, device=dev)
    feats = D.row_inputs(w, cfg, x, obj_ind[k], att_mask[k], read_out[k])
    T = cfg["seq_length"]
    if ecfg["beam_size"] > 1 and search != "greedy":
        tok, lps, _, _ = D.beam(w, cfg, feats, ecfg["beam_size"], T,
                                rank=2 if search == "second" else 1)
    else:
        tok, lps = D.greedy(w, cfg, feats, T)
    return {"keep": np.asarray(keep), "scores": scores[k].cpu().numpy(),
            "tokens": tok.cpu().numpy(), "logprobs": lps.cpu().numpy()}


def judge(w, st, cfg, ecfg, image, served, dev):
    """The numbers compared for one image's served keep set, scores,
    captions and per-token log-probabilities (``served``: keep, scores,
    tokens, logprobs, in caption order), and the captions ``beam_gap``
    judged."""
    x, obj_ind, att_mask, valid, scores, read_out, mem = _score(
        w, st, cfg, image, dev)
    keep = np.asarray(served["keep"], np.int64)
    beam = ecfg["beam_size"]
    nms = D.nms_gap(scores, mem, valid, keep, ecfg["gpn_nms_thres"],
                    ecfg["gpn_max_subg"])
    if nms >= 1.0 or not len(keep):
        out = {"sgpn_gap": 1.0, "decode_gap": 1.0}
        if beam > 1:
            out["beam_gap"] = 1.0
        return out, 0
    k = torch.as_tensor(keep, device=dev)
    ref = scores[k].double().cpu().numpy()
    score_gap = float(np.abs(np.asarray(served["scores"], np.float64)
                             - ref).max())
    feats = D.row_inputs(w, cfg, x, obj_ind[k], att_mask[k], read_out[k])
    tokens = torch.as_tensor(served["tokens"], device=dev)
    lp = D.teacher(w, cfg, feats, tokens)
    served_lp = torch.as_tensor(served["logprobs"], device=dev)
    out = {"sgpn_gap": max(score_gap, nms),
           "decode_gap": D.decode_gap(lp, tokens, served_lp, beam,
                                      beam > 1)}
    judged = 0
    if beam > 1:
        _, _, best, margin = D.beam(w, cfg, feats, beam, cfg["seq_length"])
        out["beam_gap"], judged = D.beam_gap(lp, tokens, best, margin,
                                             BEAM_TIE)
    return out, judged


def served_by_port(pred, logprobs, image_pos, B, T):
    """One image's served keep set, scores, caption tokens and per-token
    log-probabilities: ``pred`` is its prediction from the runner,
    ``logprobs`` the decode's [B * K, T] rows of its dispatch (each image's
    K rows in ascending sub-graph index), ``image_pos`` its place there."""
    keep = np.asarray(pred["sorted_subgraph_ind"], np.int64)
    K = logprobs.shape[0] // B
    rows = image_pos * K + np.searchsorted(np.sort(keep), keep)
    return {"keep": keep, "scores": pred["subgraph_score"],
            "tokens": _tokens(pred["caption"], T),
            "logprobs": logprobs[torch.as_tensor(rows)].cpu().numpy()}


def worst(numbers):
    out = {}
    for n in numbers:
        for k, v in n.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def work_of(w, st, cfg, tr, split, dev):
    """Per image of the split, from the reference's keep set: (the
    operations its inputs need, kept rows, their member nodes)."""
    ecfg = tr["eval"]
    out = []
    for image in split:
        x, obj_ind, att_mask, valid, scores, read_out, mem = _score(
            w, st, cfg, image, dev)
        keep = D.nms_keep(scores, mem, valid, ecfg["gpn_nms_thres"],
                          ecfg["gpn_max_subg"])
        sizes = att_mask.sum(-1).cpu().numpy()
        kept_nodes = float(sizes[keep].sum())
        flops = counts.test_image(
            cfg, tr["detections"], tr["relations"],
            sizes[valid.cpu().numpy().astype(bool)].tolist(), len(keep),
            kept_nodes, cfg["seq_length"], ecfg["beam_size"])
        out.append((flops, len(keep), kept_nodes))
    return out


def check_rng(seed):
    return np.random.default_rng(np.random.SeedSequence(
        [seed % (1 << 64), 7]))


def checked(order, captions):
    """The first images of ``order`` (the seed's order of the kept ones)
    that the check reads: ``CHECK_IMAGES``, and more until they hold
    ``CHECK_CAPTIONS`` captions (``captions``: each image's count)."""
    n, held = 0, 0
    for i in order:
        if n >= CHECK_IMAGES and held >= CHECK_CAPTIONS:
            break
        n, held = n + 1, held + captions[i]
    return list(order[:n])


class Kept:
    """The answers the window keeps for the check: for each of the seed's
    ``CHECK_SLOTS`` images, one window call's, each call taking the slot
    with chance 1/n (n: the calls so far), and the last call's."""

    def __init__(self, rng, n_images):
        self.rng = rng
        self.images = rng.permutation(n_images)[:CHECK_SLOTS]
        self.slots = [None] * len(self.images)
        self.calls = 0
        self.last = None

    def add(self, preds, logprobs):
        """A window call's predictions (split order) and its dispatches'
        decode log-probabilities; holds on to no other call's."""
        self.calls += 1
        take = self.rng.random(len(self.images)) * self.calls < 1.0
        for j in np.nonzero(take)[0]:
            self.slots[j] = (preds, logprobs)
        self.last = (preds, logprobs)


def run(run) -> Reading:
    from subgc_tpu_torch.config import EvalConfig
    from subgc_tpu_torch.data.dataset import ImageInfo, TestExample
    from subgc_tpu_torch.decode import beam as beam_mod
    from subgc_tpu_torch.decode import greedy as greedy_mod
    from subgc_tpu_torch.eval import runner
    from subgc_tpu_torch.graph import SceneGraph, SubgraphSet
    from subgc_tpu_torch.models import subgc
    from subgc_tpu_torch.ops import _build
    from subgc_tpu_torch.ops import attention as A
    cfg, tr, dev = run.cfg, run.traffic, torch.device(run.device)
    mcfg = model_config(cfg)
    ecfg_d = dict(tr["eval"])
    ecfg = EvalConfig(**ecfg_d, max_subgraph_bucket=tr["bucket"])
    B = tr["batch_images"]
    if dev.type == "cuda":
        with run.phase("build"):
            _build.load("attention")
    with run.phase("weights"):
        params, state = W.make(cfg, run.seed, dev)
    with run.phase("traffic"):
        split = make_split(run.seed, cfg, tr)
        examples = [TestExample(
            graph=SceneGraph(*g), subs=SubgraphSet(*s), n_subgraphs=n,
            info=ImageInfo(ix=i, id=i, file_path=""),
            gts=np.zeros((0, cfg["seq_length"]), np.int64), sg_raw={})
            for i, (g, s, n) in enumerate(split)]
        loader = _Split(examples)
        vocab = {str(i): f"w{i}" for i in range(1, cfg["vocab_size"] + 1)}

    def call():
        return runner.run_test_split(params, state, loader, mcfg, ecfg,
                                     vocab, verbose=False, batch_images=B,
                                     device=dev)[0]

    # the decode's per-token log-probabilities, a reference a dispatch of
    # the current call
    decoded = []
    decode = runner._decode

    def keep_logprobs(*a, **k):
        res = decode(*a, **k)
        decoded.append(res["logprobs"])
        return res

    spans = Spans(dev)
    layers = {}
    kept = Kept(check_rng(run.seed), len(split))
    n_window = n_images = n_caps = failed = 0
    runner._decode = keep_logprobs
    try:
        with run.phase("warm-up"):
            call()
        decoded.clear()
        setup_s = time.perf_counter() - run.t_start
        run.log("set-up: " + ", ".join(f"{k} {v:.3f} s"
                                       for k, v in run.phases.items())
                + f"; other {setup_s - sum(run.phases.values()):.3f} s; "
                f"total {setup_s:.3f} s")
        if run.trace:
            # profiled as the untraced window runs: no synchronising span
            launches = A.LAUNCHES
            traced_calls = 0
            with profiled(dev) as traced:
                tp = time.perf_counter()
                while (not traced_calls or time.perf_counter() - tp
                       < PROFILE_SECONDS):
                    call()
                    decoded.clear()
                    traced_calls += 1
            layers.update(trace=traced[0], traced_calls=traced_calls,
                          launches=A.LAUNCHES - launches)
            spans.wrap(subgc, "encode_images_batched", "encode")
            spans.wrap(beam_mod, "beam_search", "decode")
            spans.wrap(greedy_mod, "sample", "decode")
            spans.counting = True
        # the window; in the traced run, the spanned part after the profile
        t0 = time.perf_counter()
        while not n_window or time.perf_counter() - t0 < run.seconds:
            with spans.span("call", sync=False):
                preds = call()
            n_window += 1
            n_images += len(preds)
            for p in preds:
                n_caps += len(p["caption"])
                failed += not p["caption"]
            kept.add(preds, list(decoded))
            decoded.clear()
    finally:
        runner._decode = decode
        spans.restore()
    window = time.perf_counter() - t0
    if run.trace:
        layers.update(span_s=dict(spans.seconds),
                      spans_dispatches=n_window * POOL_DISPATCHES,
                      spans_wall_s=window)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    dispatches = n_window * POOL_DISPATCHES
    run.log(f"window: {n_window} calls, {dispatches} dispatches of {B} "
            f"images, {n_caps} captions ({n_caps / dispatches:.2f} a "
            f"dispatch) in {window:.3f} s")

    # the output check, on the reference's own weights
    del params, state, preds
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    w, st = W.make(cfg, run.seed, dev)
    slot = dict(zip(kept.images.tolist(), kept.slots))
    picks = [(slot[i], i) for i in checked(
        kept.images.tolist(),
        {i: len(slot[i][0][i]["caption"]) for i in slot})]
    last = kept.last[0]
    longest = max(range(len(last)), key=lambda i: max(
        (len(c.split()) for c in last[i]["caption"]), default=0))
    picks.append((kept.last, longest))
    numbers, judged = [], 0
    T = cfg["seq_length"]
    with torch.no_grad():
        for (preds, logprobs), ii in picks:
            served = served_by_port(preds[ii], logprobs[ii // B], ii % B, B,
                                    T)
            n, j = judge(w, st, cfg, ecfg_d, split[ii], served, dev)
            numbers.append(n)
            judged += j
        if run.trace:
            layers["work"] = work_of(w, st, cfg, tr, split, dev)
    checks = worst(numbers)
    n_checked = sum(len(p[ii]["caption"]) for (p, _), ii in picks)
    run.log(f"check: {len(picks)} images, {n_checked} captions"
            + (f" ({judged} clear of beam ties)" if ecfg.beam_size > 1
               else "")
            + f" in {time.perf_counter() - t_check:.3f} s")
    layers.update(cfg=cfg, traffic=tr)
    reading = Reading(
        attempted=n_images, failed=failed,
        end_to_end={"captions_per_s": n_caps / window, "setup_s": setup_s},
        checks=checks, memory_peak_bytes=peak, layers=layers)
    if run.trace:
        t = layers["trace"]
        reading.device = {"busy_s": t.busy_s, "window_s": t.window_s}
        reading.breakdown = {"device_ops": t.device_ops(),
                             "idle_gaps": t.idle_gaps()}
    return reading
