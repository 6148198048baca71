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
(``eval/grounding.py::GroundingCollector``).

Sharding over a device mesh (``parallel/mesh.py``) runs in this process,
one thread per mesh device, as the JAX package's single-process mesh runs:

* ``shard_axis="image"``: each device encodes and decodes ``batch_images /
  n`` images of every dispatch;
* ``shard_axis="subgraph"``: the first device encodes the dispatch and runs
  the NMS once (the JAX program runs that part redundantly on every
  device, with the same result), then the flat ``[B*Smax]`` decode rows
  split into contiguous chunks, one per device, so that one image's
  keep-1000 fan-out spreads over the devices.

Only the kept rows decode (NMS pads each image's keep set to
``gpn_max_subg`` slots; under SCT ``subs.valid`` marks the real region
sets); the decode's outputs in the other slots are zeros.  The outputs
equal the unsharded run's: the top-k draws are the unsharded row shape's,
cut to each shard's kept rows.  In-process sharding is slower than
one card on every path measured (``PERF.md``): the decode is host-bound,
and the threads share one interpreter lock.  It stays so until a process
per card decodes its shard.
"""
from __future__ import annotations

import os
import threading
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
from ..parallel import mesh as M
from ..utils.profiling import span
from ..utils.text import decode_sequence


# PreparedFeatures' row-leading fields; att_img / p_att_img are per image
ROW_FIELDS = ("fc", "att", "p_att", "mask", "fc_ih", "img_ix")
# a beam search on the card replays captured graphs by its row count
# (decode/graphs.py), so its kept rows are gathered in multiples of this
# many, the last padded by repeats of the first kept row: a split's
# dispatches then share a few keys, not one key a kept count
BEAM_ROW_BUCKET = 32


def _take_rows(feats, idx):
    """``feats`` at rows ``idx``: the row-leading fields gathered, the
    per-image streams as they are (``img_ix`` still maps each row to its
    image's)."""
    return feats._replace(**{
        f: getattr(feats, f).index_select(0, idx) for f in ROW_FIELDS
        if getattr(feats, f) is not None})


def _decode_rows(params, feats, cfg: ModelConfig, ecfg: EvalConfig,
                 generator, rows):
    """Beam search, or greedy / top-k at ``beam_size`` 1, of every row of
    ``feats``."""
    if ecfg.beam_size > 1:
        out = beam_mod.beam_search(params, feats, cfg, ecfg)
        res = dict(seq=out.seq, logprobs=out.logprobs)
        if ecfg.verbose_beam:
            res["all_beams"] = out.all_seqs
        return res
    out = greedy_mod.sample(params, feats, cfg, ecfg, generator, rows=rows)
    res = dict(seq=out.seq, logprobs=out.logprobs)
    if ecfg.return_att:
        res["att_weights"] = out.att_weights
    return res


def _row_bucket(feats, ecfg: EvalConfig) -> int:
    """The multiple :func:`_decode` gathers kept rows in:
    :data:`BEAM_ROW_BUCKET` for a beam search on the card, else 1."""
    return BEAM_ROW_BUCKET if ecfg.beam_size > 1 and feats.fc.is_cuda else 1


def _bucketed(sel, S, bucket):
    """``sel`` padded by repeats of its first row to a multiple of
    ``bucket`` rows, or to ``S`` if that is fewer."""
    pad = min(-(-sel.numel() // bucket) * bucket, S) - sel.numel()
    return torch.cat([sel, sel[:1].expand(pad)]) if pad > 0 else sel


def _decode(params, feats, keep, cfg: ModelConfig, ecfg: EvalConfig,
            generator=None, rows=None):
    """Beam search, or greedy / top-k at ``beam_size`` 1, of the rows of
    ``feats`` that ``keep`` [S] bool marks (NMS's kept sub-graphs; under
    SCT the real region sets): a dict of [S, ...] tensors out, zeros in
    the other rows.  The kept rows are gathered, decoded and put back;
    finding them is one host sync, and with every row kept nothing is
    gathered.  ``rows=(offset, total)``: the top-k draws are those of rows
    ``offset ..`` of a ``total``-row decode.  A kept row decodes, and
    draws, as it does in a decode of every row.  A beam search on the card
    decodes its kept rows in buckets (:data:`BEAM_ROW_BUCKET`)."""
    S = feats.fc.shape[0]
    idx = torch.nonzero(keep).flatten()
    n = idx.numel()
    if n == S:
        return _decode_rows(params, feats, cfg, ecfg, generator, rows)
    # nothing kept: one row decodes, for the outputs' shapes
    sel = _bucketed(idx if n else idx.new_zeros(1), S,
                    _row_bucket(feats, ecfg))
    offset, total = rows if rows is not None else (0, S)
    res = _decode_rows(params, _take_rows(feats, sel), cfg, ecfg, generator,
                       (sel + offset, total))
    return {k: v.new_zeros((S,) + v.shape[1:]).index_copy_(0, idx, v[:n])
            for k, v in res.items()}


def _fork(generator, device):
    """A generator on ``device`` in ``generator``'s state (or None)."""
    if generator is None:
        return None
    g = torch.Generator(device=device)
    g.set_state(generator.get_state())
    return g


def _run_on_devices(devices, jobs):
    """Run ``jobs[i]()`` on ``devices[i]``, each from a thread of its own
    with that card current (a device listed twice takes both jobs in
    turn, on its one stream).  Returns the results in order; raises the
    first failure."""
    out = [None] * len(jobs)
    errors = []

    def work(i):
        try:
            dev = torch.device(devices[i])
            if dev.type == "cuda":
                with torch.cuda.device(dev), torch.no_grad():
                    out[i] = jobs[i]()
            else:
                with torch.no_grad():
                    out[i] = jobs[i]()
        except Exception as e:          # re-raised below, on the caller
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _decode_sharded(params, feats, keep, mesh, cfg, ecfg, generator):
    """Sub-graph-axis decode: ``feats`` rows (on the first mesh device)
    split into one contiguous chunk per device; the row-leading fields
    and ``keep`` are chunked, the per-image streams
    ``att_img``/``p_att_img`` replicated, so each row's image gather stays
    on its device (the JAX runner's sharding constraints,
    ``subgc_tpu/eval/runner.py:80-97``).  Each device decodes its chunk's
    kept rows.  ``params`` holds one copy per device.  Returns the
    gathered outputs in row order on the first device."""
    S = feats.fc.shape[0]
    rowwise = {f: getattr(feats, f) for f in ROW_FIELDS}
    chunks = M.shard_leading_axis(mesh, dict(rowwise, keep=keep))
    images = M.replicate(mesh, dict(att_img=feats.att_img,
                                    p_att_img=feats.p_att_img))
    gens = [_fork(generator, d) for d in mesh.devices]
    offsets = np.cumsum([0] + [c["fc"].shape[0] for c in chunks])
    keeps = [c.pop("keep") for c in chunks]
    jobs = [lambda k=k: _decode(
        params[k], feats._replace(**chunks[k], **images[k]), keeps[k], cfg,
        ecfg, gens[k], rows=(int(offsets[k]), S)) for k in range(mesh.size)]
    outs = _run_on_devices(mesh.devices, jobs)
    if generator is not None:
        # every shard drew the whole row shape: step the split's generator
        # as the unsharded decode would
        generator.set_state(gens[0].get_state())
    return M.gather_leading_axis(outs)


def make_batched_infer_fn(cfg: ModelConfig, ecfg: EvalConfig, mesh=None):
    """[B]-image program: graph [B, ...] and subs [B, S, ...] tensors in,
    a dict of [B, Smax, ...] tensors out (seq, logprobs, scores, keep_ind,
    keep_valid; att_weights under ``return_att``; every beam's tokens,
    all_beams, under ``verbose_beam``).  Only the rows ``keep_valid``
    marks decode; the decode's outputs are zeros in the others.
    ``generator`` feeds the top-k draws; ``images=(first, total)`` says
    that this batch is images ``first ..`` of a ``total``-image dispatch
    (an image-axis shard), whose draws it takes for its rows.

    ``mesh``: the sub-graph-axis program.  ``params`` and ``state`` are
    then ``mesh.replicate``'s per-device lists, graph and subs lie on the
    first device, where the encoder and NMS run once; the decode rows
    shard over the mesh (:func:`_decode_sharded`)."""

    @torch.no_grad()
    def infer(params, state, graph, subs, generator=None, images=None):
        p0, s0 = (params, state) if mesh is None else (params[0], state[0])
        enc = subgc.encode_images_batched(p0, s0, graph, subs, cfg, ecfg)
        B = graph.obj_fmap.shape[0]
        if mesh is None:
            rows = None
            if images is not None:
                K = enc.feats.fc.shape[0] // B      # rows per image
                rows = (images[0] * K, images[1] * K)
            res = _decode(p0, enc.feats, enc.keep_valid, cfg, ecfg,
                          generator, rows)
        else:
            res = _decode_sharded(params, enc.feats, enc.keep_valid, mesh,
                                  cfg, ecfg, generator)
        res.update(scores=enc.scores, keep_ind=enc.keep_ind,
                   keep_valid=enc.keep_valid)
        return {k: v.reshape((B, -1) + v.shape[1:]) for k, v in res.items()}

    return infer


def _infer_image_sharded(infer, params, state, graph, subs, mesh,
                         generator):
    """Image-axis dispatch: each mesh device runs ``infer`` on its
    contiguous share of the images (host arrays, placed straight on it);
    the outputs gathered in image order on the first device."""
    with span("subgc.test.to_device"):
        graphs = M.shard_leading_axis(mesh, to_device(graph, "cpu"))
        subss = M.shard_leading_axis(mesh, to_device(subs, "cpu"))
    B = graph.obj_fmap.shape[0]
    starts = np.cumsum([0] + [g.obj_fmap.shape[0] for g in graphs])
    gens = [_fork(generator, d) for d in mesh.devices]
    outs = _run_on_devices(mesh.devices, [
        lambda k=k: infer(params[k], state[k], graphs[k], subss[k], gens[k],
                          images=(int(starts[k]), B))
        for k in range(mesh.size)])
    if generator is not None:
        generator.set_state(gens[0].get_state())
    return M.gather_leading_axis(outs)


def _to_device(graph, subs, dev):
    with span("subgc.test.to_device"):
        return to_device(graph, dev), to_device(subs, dev)


def _stack_examples(examples):
    graph = SceneGraph(*[np.concatenate([getattr(e.graph, f) for e in examples])
                         for f in SceneGraph._fields])
    subs = SubgraphSet(*[np.stack([getattr(e.subs, f) for e in examples])
                         for f in SubgraphSet._fields])
    return graph, subs


def _add_predictions(predictions, out, chunk, vocab, ecfg: EvalConfig,
                     keep_tokens, collect_grounding, vb_rng, verbose) -> int:
    """Append the predictions of one dispatch's images (``chunk``) from its
    outputs on the host (``out``) to ``predictions``; returns the number of
    captions."""
    n_caps = 0
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
    return n_caps


@f32_accumulation()
def run_test_split(params, state, loader, cfg: ModelConfig, ecfg: EvalConfig,
                   vocab, split: str = "test", num_images: int = -1,
                   verbose: bool = True, batch_images: int = 16,
                   keep_tokens: bool = False, device="cuda",
                   collect_grounding=None, mesh=None,
                   shard_axis: str = "image"):
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

    Dispatches run in two stages: dispatch k's decode is queued on the
    card before dispatch k-1's predictions are written (and
    ``collect_grounding`` called) and dispatch k+1's inputs are stacked;
    then dispatch k is read back.  Predictions, callbacks and print-out
    come in split order, as one dispatch after another would give them.

    Top-k draws come from one generator on ``device`` for the whole split,
    seeded with 2019 as the JAX package's default key is.  bfloat16 matmuls
    sum in float32 throughout (``device.f32_accumulation``).

    mesh: an optional ``parallel.mesh.Mesh``, which takes the place of
    ``device`` (its first device holds the generator and gathers the
    outputs): params and state replicate onto it (or come as
    ``parallel.mesh.replicate``'s per-device lists, so that repeated calls
    copy nothing) and, per ``shard_axis``,
    the image axis ("image") or the flat sub-graph-row axis ("subgraph":
    any batch_images; a single keep-1000 image spreads over the devices)
    shards over it.  The captions, keep sets and scores are the unsharded
    run's, but the wall time is longer than on one card (see above).
    """
    if shard_axis not in ("image", "subgraph"):
        raise ValueError(f"shard_axis must be 'image' or 'subgraph', "
                         f"got {shard_axis!r}")
    if shard_axis != "image" and mesh is None:
        raise ValueError(
            f"shard_axis={shard_axis!r} requires a mesh (it would silently "
            f"run unsharded otherwise); pass mesh= or use shard_axis='image'")
    if not cfg.use_gpn:
        raise ValueError(
            "run_test_split decodes Sub-GC models only: Full-GC "
            "(use_gpn=False) has no batched route, in the JAX package's "
            "runner either; decode it per image with encode_image + "
            "beam_search")
    with span("subgc.test.split"):
        if mesh is None:
            dev = resolve_device(device)
            run = make_batched_infer_fn(cfg, ecfg)

            def dispatch(graph, subs, generator):
                return run(params, state, *_to_device(graph, subs, dev),
                           generator)
        else:
            dev = resolve_device(mesh.devices[0])
            for d in mesh.devices[1:]:
                resolve_device(d)
            params_m = params if isinstance(params, list) \
                else M.replicate(mesh, params)
            state_m = state if isinstance(state, list) \
                else M.replicate(mesh, state)
            if shard_axis == "subgraph":
                run = make_batched_infer_fn(cfg, ecfg, mesh=mesh)

                def dispatch(graph, subs, generator):
                    return run(params_m, state_m,
                               *_to_device(graph, subs, dev), generator)
            else:
                run = make_batched_infer_fn(cfg, ecfg)

                def dispatch(graph, subs, generator):
                    return _infer_image_sharded(run, params_m, state_m, graph,
                                                subs, mesh, generator)
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

        def stack(i):
            with span("subgc.test.stack"):
                chunk = examples[i:i + batch_images]
                # fixed-size image batches (the last one padded by
                # repetition)
                padded = chunk + [chunk[-1]] * (batch_images - len(chunk))
                return chunk, _stack_examples(padded)

        def captions(host_out, chunk):
            with span("subgc.test.captions"):
                return _add_predictions(
                    predictions, host_out, chunk, vocab, ecfg, keep_tokens,
                    collect_grounding, vb_rng, verbose)

        # Two stages: the decode's launches return before the card has run
        # them, so the host writes the previous dispatch's captions and
        # stacks the next dispatch's inputs while the card decodes this one.
        # The encoder's NMS rounds and the kept-row read sync the stream, so
        # one dispatch in flight is all a deeper queue would hold.
        nxt = stack(0)
        done = None            # the previous dispatch's host outputs, images
        for i in range(0, len(examples), batch_images):
            with span("subgc.test.dispatch"):
                chunk, inputs = nxt
                out = dispatch(*inputs, generator)
                if done is not None:
                    n_caps += captions(*done)
                if i + batch_images < len(examples):
                    nxt = stack(i + batch_images)
                # the host's wait for the device, and the copy back
                with span("subgc.test.readback"):
                    out = {k: v.cpu().numpy() for k, v in out.items()}
                done = out, chunk
        n_caps += captions(*done)
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
