"""Training: the loop of ``subgc_tpu_torch/cli/train.py``, a
``BatchPrefetcher`` (pinned copies on its own stream) feeding the step of
``train/step.py::make_train_step`` that the CLI takes while scheduled
sampling is off, from a seeded pool of host batches.

The mix (``portbench/traffic/<mix>.json``) gives the batch (images,
sentences an image, sub-graphs a sentence), the optimizer's settings and
the iteration the run starts at (past the learning-rate warm-up, as most
of a run is).  The host batches cycle through a pool of ``POOL_BATCHES``
distinct ones, behind the CLI's prefetch depth (``PREFETCH_DEPTH``).

Set-up builds one training state, drives it from the seed through the
first ``CHECKED_STEPS`` steps through the window's own call and feed (on
distinct batches), and hands that state to the window.  End to end:
``train_images_per_s``, images consumed by steps over the whole window.
The traced run profiles its first ``PROFILE_SECONDS`` as the untraced
window runs, then spans the step (synchronised) and the wait for a batch
over the rest.

Output check against ``portbench/reference/train.py`` (float32, TF32 off)
from weights it makes again from the seed, on the same batches and dropout
draws:

* ``first_loss_gap``: the first checked step's loss, the gap relative to
  the reference's;
* ``grad_gap``: the first gradient as the optimizer got it (Adam's first
  moment after one step over 1 - b1), each leaf's norm against the
  reference's, the gap over the larger of that leaf's norm and the median
  leaf's, the worst leaf;
* ``median_update_gap``: the parameters' change over the checked steps,
  each leaf read the same way, the median leaf.

The later steps' losses and the worst leaf's change are not compared:
Adam scales each element's step to about the learning rate, so an element
whose gradient is near nought (a sum that cancels) moves by its round-off,
and those readings swing from seed to seed on sound runs.  Leaves whose
reference gradient is under a thousandth of the median leaf's (the
attention logit's bias, which softmax ignores) move by round-off alone and
are left out of both gradient and change.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import weights as W
from ..harness import Reading
from ..metrics import counts
from ..reference import train as RT
from ..traffic.train_batch import train_batch
from . import model_config
from .spans import Spans, profiled

GRAPH_KEYS = ("obj_fmap", "obj_dist", "rel_ind", "pred_dist")
INT_KEYS = ("rel_ind", "labels", "sub_obj_ind", "img_ix")
POOL_BATCHES = 4        # distinct host batches
PREFETCH_DEPTH = 2      # cli/train.py's default
CHECKED_STEPS = 3       # steps the output check follows
PROFILE_SECONDS = 2.0   # the traced run's profiled part


def dropout_seed(seed):
    return int(np.random.SeedSequence([seed % (1 << 64), 5])
               .generate_state(1)[0])


def batch_tensors(host, dev):
    """A host batch (dict of arrays) as the reference's tensors."""
    return {k: torch.from_numpy(v).to(dev).long() if k in INT_KEYS
            else torch.from_numpy(v).to(dev) for k, v in host.items()}


def norm_gaps(port, ref, keep, over=max):
    """Each leaf's gap between the port's and the reference's norms, over
    the larger of that leaf's reference norm and the median one's; the
    worst leaf's (``over``: max) or the median leaf's (np.median)."""
    rn = {k: float(ref[k].double().norm()) for k in keep}
    med = float(np.median(list(rn.values())))
    return float(over([abs(float(port[k].double().norm()) - rn[k])
                       / max(rn[k], med) for k in keep]))


def reference_numbers(cfg, tr, seed, pool, dev, fault=None):
    """The reference's checked steps: (losses, first gradients by leaf,
    change of each leaf).  ``fault`` plants a fault in the reference put in
    the program's place: ``"half_batch"`` (the loss over the first half of
    the sentences) or ``"token"`` (one caption token altered)."""
    w0, st = W.make(cfg, seed, dev)
    w = W.clone(w0)
    batches = [batch_tensors(pool[i % len(pool)], dev)
               for i in range(CHECKED_STEPS)]
    if fault == "half_batch":
        half = batches[0]["labels"].shape[0] // 2
        for b in batches:
            b["masks"] = b["masks"].clone()
            b["masks"][half:] = 0.0
    elif fault == "token":
        for b in batches:
            b["labels"] = b["labels"].clone()
            b["labels"][0, 1] = b["labels"][0, 1] % (cfg["vocab_size"] - 1) + 1
    losses, first = RT.run_steps(
        w, st, cfg, batches, dropout_seed(seed), tr["train"]["learning_rate"],
        cfg["drop_prob_lm"], CHECKED_STEPS)
    delta = {k: p - p0 for (k, p), (_, p0)
             in zip(RT.leaves(w), RT.leaves(w0))}
    return losses, first, delta


def kept_leaves(grads):
    """The leaves compared: reference gradient at least a thousandth of
    the median leaf's."""
    gnorm = {k: float(g.double().norm()) for k, g in grads.items()}
    med = float(np.median(list(gnorm.values())))
    return [k for k, n in gnorm.items() if n >= 1e-3 * med]


def compare(port, ref):
    """The compared numbers of a run (``port``) against the reference's
    (each: losses, first gradients, changes by leaf)."""
    lp, gp, dp = port
    lr_, gr, dr = ref
    keep = kept_leaves(gr)
    return {
        "first_loss_gap": abs(lp[0] - lr_[0]) / abs(lr_[0]),
        "grad_gap": norm_gaps(gp, gr, keep),
        "median_update_gap": norm_gaps(dp, dr, keep, np.median)}


def step_work(cfg, tr, host):
    """Operations one step on ``host`` needs (``counts.train_step``); a
    Sub-GC sentence's attended nodes counted as the mean of its two
    positives (the sGPN picks one)."""
    masks = host["masks"][:, 1:cfg["seq_length"] + 2]
    positions = masks.sum(1).tolist()
    if cfg["use_gpn"]:
        sizes = host["sub_att_mask"].sum(-1)               # [S, 2, half]
        sentence_nodes = sizes[:, 0].mean(-1).tolist()
        sub_nodes = sizes.reshape(-1).tolist()
    else:
        sentence_nodes = [cfg["obj_num"] - 1] * len(positions)
        sub_nodes = []
    return counts.train_step(cfg, tr["batch_images"], cfg["obj_num"] - 1,
                             cfg["rel_num"], sentence_nodes, sub_nodes,
                             positions)


def run(run) -> Reading:
    from subgc_tpu_torch.config import TrainConfig
    from subgc_tpu_torch.data import prefetch as prefetch_mod
    from subgc_tpu_torch.graph import SceneGraph
    from subgc_tpu_torch.train import optim
    from subgc_tpu_torch.train import step as step_mod

    cfg, tr, dev = run.cfg, run.traffic, torch.device(run.device)
    mcfg = model_config(cfg)
    B = tr["batch_images"]
    tcfg = TrainConfig(batch_size=B, seq_per_img=tr["seq_per_img"],
                       gpn_batch=tr["gpn_batch"], **tr["train"])
    with run.phase("weights"):
        params, state = W.make(cfg, run.seed, dev)
        for p in optim.tree_leaves(params):
            p.requires_grad_(True)
    with run.phase("traffic"):
        pool = [train_batch(run.seed, i, cfg, B, tr["seq_per_img"],
                            tr["gpn_batch"])
                for i in range(POOL_BATCHES)]
        host = [step_mod.TrainBatch(
            graph=SceneGraph(*(b[k] for k in GRAPH_KEYS)),
            labels=b["labels"], masks=b["masks"],
            sub_obj_ind=b["sub_obj_ind"], sub_att_mask=b["sub_att_mask"],
            img_ix=b["img_ix"]) for b in pool]
    served = [0]

    def get_batch():
        b = host[served[0] % len(host)]
        served[0] += 1
        return (b,)

    def place(b):
        return step_mod.batch_to_device(b, dev,
                                        non_blocking=dev.type == "cuda")

    step = step_mod.make_train_step(mcfg, tcfg, ss_active=False)
    gen = torch.Generator(device=dev).manual_seed(dropout_seed(run.seed))
    ts = step_mod.init_train_state(params, state, tcfg,
                                   step=tr["start_iteration"])
    prefetch = prefetch_mod.BatchPrefetcher(
        get_batch, depth=PREFETCH_DEPTH, device=dev, place=place)
    spans = Spans(dev)
    layers = {}
    try:
        losses = []
        with run.phase("checked steps"):
            for i in range(CHECKED_STEPS):
                batch, _ = prefetch.next()
                ts, metrics = step(ts, batch, gen, 0, 0.0)
                losses.append(metrics["loss"])
                if i == 0:
                    b1 = np.float32(tcfg.optim_alpha)
                    mu = RT.leaves(ts.opt_state.moments["mu"])
                    first = {k: m.detach().clone() / float(1 - b1)
                             for k, m in mu}
            after = {k: p.detach().clone() for k, p in RT.leaves(ts.params)}
            losses = [float(x) for x in losses]
        setup_s = time.perf_counter() - run.t_start
        run.log("set-up: " + ", ".join(f"{k} {v:.3f} s"
                                       for k, v in run.phases.items())
                + f"; other {setup_s - sum(run.phases.values()):.3f} s; "
                f"total {setup_s:.3f} s")

        def one(n):
            nonlocal ts
            with spans.span("input_wait", sync=False):
                batch, _ = prefetch.next()
            # synchronised only once the profile is over
            with spans.span("step", sync=spans.counting):
                ts, metrics = step(ts, batch, gen, 0, 0.0)
            if (n + 1) % 5 == 0:       # the CLI's log read every 5 steps
                m = {k: float(v) for k, v in metrics.items()}
                return int(not np.isfinite(m["loss"]))
            return 0

        n, failed = 0, 0
        if run.trace:
            with profiled(dev) as traced:
                tp = time.perf_counter()
                while (not n or time.perf_counter() - tp
                       < PROFILE_SECONDS):
                    failed += one(n)
                    n += 1
            layers.update(trace=traced[0], traced_steps=n,
                          step_flops=float(np.mean([step_work(cfg, tr, b)
                                                    for b in pool])))
            spans.counting = True
        # the window; in the traced run, the spanned part after the profile
        n_window = 0
        t0 = time.perf_counter()
        while not n_window or time.perf_counter() - t0 < run.seconds:
            failed += one(n)
            n += 1
            n_window += 1
        if dev.type == "cuda":
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
        if run.trace:
            layers.update(span_s=dict(spans.seconds), spans_steps=n_window)
    finally:
        prefetch.stop()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    run.log(f"window: {n_window} steps of {B} images in {window:.3f} s")
    del ts, params, state, batch, metrics
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    w0, _ = W.make(cfg, run.seed, dev)
    delta = {k: after[k] - p0 for k, p0 in RT.leaves(w0)}
    del w0, after
    ref = reference_numbers(cfg, tr, run.seed, pool, dev)
    checks = compare((losses, first, delta), ref)
    run.log(f"check: {CHECKED_STEPS} steps, losses {losses} "
            f"(reference {ref[0]}) in {time.perf_counter() - t_check:.3f} s")
    reading = Reading(
        attempted=n_window, failed=failed,
        end_to_end={"train_images_per_s": n_window * B / window,
                    "setup_s": setup_s},
        checks=checks, memory_peak_bytes=peak, layers=layers)
    if run.trace:
        t = layers["trace"]
        reading.device = {"busy_s": t.busy_s, "window_s": t.window_s}
        reading.breakdown = {"device_ops": t.device_ops(),
                             "idle_gaps": t.idle_gaps()}
    return reading
