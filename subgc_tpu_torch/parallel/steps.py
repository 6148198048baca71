"""Data-parallel train steps from one spec, in one process or in ranks.

:func:`run_steps` runs a spec's train steps, val pass and SCST step on
one device, alone (``group=None``) or as one rank of a process group;
:func:`train_rank` is the rank entry that ``launch.spawn`` starts.  From
the spec every rank builds the same weights and the same global batches
and keeps its slice, so a run over W ranks is held against the
single-process run of the same spec (:func:`same_gradients`,
:func:`same_parameters`): the losses, the gradients the optimizer gets and
the parameters agree within float32 summation order, and every rank ends
with the same parameter bits.  The CPU tests and ``chip_smoke.py`` use it.

A spec is a dict:

* ``cfg``, ``tcfg``: ``ModelConfig`` / ``TrainConfig`` field dicts;
* ``params``: ``(params, state)`` numpy trees, or ``params_seed`` for
  ``init_params_numpy(cfg, seed)``;
* ``batches``: global numpy ``TrainBatch``es, one per step;
* ``steps``: a ``ss_prob`` per step, None for the hoisted step (scheduled
  sampling off);
* ``seed``: the dropout / sampling generator's seed (None: no dropout);
* ``step0``: the optimizer step to start from (default 0);
* ``val_batch``: a global batch for one val pass (optional);
* ``scst``: ``(batch, gts_tokens, vocab)`` for one SCST step after the
  others (optional);
* ``time``: synchronise and time each step, and time an all-reduce of a
  bucket of the parameters' size;
* ``grads``: keep the gradients the optimizer gets in the first step whose
  learning rate is not 0 (summed over the ranks).
"""
from __future__ import annotations

import hashlib
import os
import pickle
import statistics
import time

import numpy as np
import torch
import torch.distributed as dist

from .mesh import tree_map


def _params_checksum(leaves) -> str:
    h = hashlib.sha256()
    for t in leaves:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _to_numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_steps(spec, device, group=None, rank: int = 0, world: int = 1,
              keep_params: bool = True) -> dict:
    """Run ``spec`` on ``device`` (as rank ``rank`` of ``world`` under
    ``group``).  Returns a report: ``metrics`` (per step, the global
    values), ``checksum`` of the final parameters, ``params`` / ``state``
    (numpy, when ``keep_params``), ``val_loss``, ``val_launches`` (the
    attention kernels' counts in the val pass), ``step_ms`` and
    ``allreduce_ms`` (when timed), ``scst`` (loss, mean reward),
    ``grads`` (numpy, when asked for and ``keep_params``)."""
    from ..config import ModelConfig, TrainConfig
    from ..device import pin_matmul_numerics
    from ..models.params import init_params_numpy, params_from_numpy
    from ..ops import attention as A
    from ..train import optim
    from ..train import step as ST

    pin_matmul_numerics()           # TF32 off, bf16 sums in float32
    dev = torch.device(device)
    cfg = ModelConfig(**spec["cfg"])
    tcfg = TrainConfig(**spec["tcfg"])
    if spec.get("params") is not None:
        params_np, state_np = spec["params"]
    else:
        params_np, state_np = init_params_numpy(cfg,
                                                seed=spec["params_seed"])
    ts = ST.init_train_state(params_from_numpy(params_np, dev, True),
                             params_from_numpy(state_np, dev), tcfg,
                             step=spec.get("step0", 0))
    gen = (torch.Generator(device=dev).manual_seed(spec["seed"])
           if spec.get("seed") is not None else None)
    steps = {False: ST.make_train_step(cfg, tcfg, ss_active=False,
                                       group=group),
             True: ST.make_train_step(cfg, tcfg, group=group)}

    def local(b):
        return ST.batch_to_device(ST.local_train_batch(b, rank, world), dev)

    report = {"metrics": [], "step_ms": []}
    want_grads = spec.get("grads") and keep_params
    for b, ss in zip(spec["batches"], spec["steps"]):
        batch = local(b)
        grads = [] if want_grads and "grads" not in report \
            and optim.learning_rate(ts.step, 0, tcfg) > 0 else None
        _sync(dev)
        t0 = time.perf_counter()
        ts, m = steps[ss is not None](ts, batch, gen, 0, ss or 0.0, grads)
        _sync(dev)
        if grads:
            # None: a leaf the loss does not reach
            it = iter(torch.zeros_like(p) if g is None else g for g, p in
                      zip(grads, optim.tree_leaves(ts.params)))
            report["grads"] = optim.tree_map(lambda _: _to_numpy(next(it)),
                                             ts.params)
        report["step_ms"].append(1e3 * (time.perf_counter() - t0))
        report["metrics"].append({k: float(v) for k, v in m.items()})
    if spec.get("val_batch") is not None:
        val = ST.make_val_step(cfg, group)
        vb = local(spec["val_batch"])
        _sync(dev)
        A.reset_launch_counts()
        report["val_loss"] = float(val(ts.params, ts.model_state, vb))
        report["val_launches"] = {
            "row": A.ROW_LAUNCHES + A.ROW_BF16_LAUNCHES,
            "shared": A.LAUNCHES + A.SHARED_BF16_LAUNCHES,
            "project": A.PROJECT_LAUNCHES}
    if spec.get("scst") is not None:
        from ..train.scst import (make_sample_fn, make_scst_update_fn,
                                  scst_train_step)
        b, gts, vocab = spec["scst"]
        ts, loss, reward = scst_train_step(
            ts, local(b), gts, vocab, make_sample_fn(cfg, group),
            make_scst_update_fn(cfg, tcfg, group),
            torch.Generator(device=dev).manual_seed(spec.get("seed") or 0),
            0, group)
        report["scst"] = (loss, reward)
    leaves = optim.tree_leaves(ts.params)
    report["checksum"] = _params_checksum(leaves)
    if keep_params:
        report["params"] = _to_numpy(ts.params)
        report["state"] = _to_numpy(ts.model_state)
    if spec.get("time") and group is not None:
        bucket = torch.ones(sum(t.numel() for t in leaves), device=dev)
        ms = []
        for _ in range(4):
            _sync(dev)
            t0 = time.perf_counter()
            dist.all_reduce(bucket, group=group)
            _sync(dev)
            ms.append(1e3 * (time.perf_counter() - t0))
        report["allreduce_ms"] = statistics.median(ms[1:])
        report["bucket_mib"] = bucket.numel() * 4 / 2 ** 20
    return report


def train_rank(rank, world, device, startup, specs, out_dir):
    """Rank entry for ``launch.spawn``: :func:`run_steps` of every spec in
    the default group, the list of reports (rank 0's with the parameters)
    pickled to ``out_dir/rank<r>.pkl``."""
    reports = []
    for spec in specs:
        report = run_steps(spec, device, dist.group.WORLD, rank, world,
                           keep_params=rank == 0)
        report.update(startup_s=startup, device=str(device),
                      backend=dist.get_backend())
        reports.append(report)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(reports, f)


def run_ranks(specs, devices, out_dir, backend=None) -> list:
    """Spawn one rank per entry of ``devices``, each running every spec of
    ``specs`` in turn; returns ``reports[rank][spec]``.  Raises if a rank
    fails."""
    from . import launch
    launch.spawn(train_rank, len(devices), devices, backend,
                 args=(list(specs), out_dir))
    reports = []
    for r in range(len(devices)):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            reports.append(pickle.load(f))
    return reports


def zero_gradient_leaves(params, prefix="") -> set:
    """Names of the parameters whose gradient is zero in exact arithmetic:
    the attention's logit bias ``decoder.alpha_net.b`` (the softmax
    cancels a shift of every logit), the biases of a GCN collection unit
    followed by BatchNorm (Full-GC's ``gcn_bn``), whose constant shift the
    normalisation removes, and under Full-GC (no sGPN, every unit
    normalised) the relation embedding's bias ``fusion.pred_emb_proj.b``:
    the relation features reach the loss only through those units.  Their
    float gradient is summation noise, whose sign Adam's step turns into a
    move of up to the learning rate in either direction."""
    out = set()
    if not prefix and "gpn" not in params and params.get("gcn") and all(
            "bn" in u for layer in params["gcn"] for u in layer):
        out.add("fusion.pred_emb_proj.b")
    if isinstance(params, dict):
        if "bn" in params and "lft" in params and "rgt" in params:
            out |= {f"{prefix}lft.b", f"{prefix}rgt.b"}
        if prefix == "decoder." and "alpha_net" in params:
            out.add("decoder.alpha_net.b")
        for k, v in params.items():
            out |= zero_gradient_leaves(v, f"{prefix}{k}.")
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            out |= zero_gradient_leaves(v, f"{prefix}{i}.")
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _same_leaves(a, b, what):
    a, b = dict(_flat(a)), dict(_flat(b))
    if sorted(a) != sorted(b):
        raise ValueError(f"{what}: leaves differ")
    return a, b


def same_parameters(report, ref, rtol=2e-4, atol=1e-6,
                    parts=("params", "state")) -> list:
    """The leaves of ``report``'s parameters and running statistics
    (``parts``) that differ from ``ref``'s beyond ``rtol`` / ``atol``, as
    ``(name, max |difference|, elements beyond, elements)``; raises when
    the two trees have other leaves.  The :func:`zero_gradient_leaves`
    are left to :func:`same_gradients`: Adam moves them by the sign of
    float noise."""
    skip = {f"params.{k}" for k in zero_gradient_leaves(ref["params"])}
    bad = []
    for part in parts:
        a, b = _same_leaves(report[part], ref[part], part)
        for k in a:
            if f"{part}.{k}" in skip:
                continue
            diff = np.abs(a[k] - b[k])
            over = diff > atol + rtol * np.abs(b[k])
            if over.any():
                bad.append((f"{part}.{k}", float(diff.max()),
                            int(over.sum()), int(over.size)))
    return bad


def gradient_errors(report, ref) -> dict:
    """For the gradients the two runs kept (``grads``), per leaf ``(|g -
    g_ref| / |g_ref|, |g_ref|)`` in L2 norms, and under ``""`` the same
    over every leaf as one vector."""
    a, b = _same_leaves(report["grads"], ref["grads"], "grads")
    out, d2, n2 = {}, 0.0, 0.0
    for k in b:
        d = float(np.linalg.norm((a[k] - b[k]).astype(np.float64)))
        n = float(np.linalg.norm(b[k].astype(np.float64)))
        out[k] = (d / n if n > 0 else float(d > 0), n)
        d2, n2 = d2 + d * d, n2 + n * n
    out[""] = (np.sqrt(d2 / n2), np.sqrt(n2))
    return out


def one_ulp_away(tree, seed: int = 0):
    """A numpy float32 tree with every element moved by one ulp, up or
    down at random (``seed``): a run from it shows how far float rounding
    of the inputs alone moves a result (a ReLU input near 0 may take the
    other side), the scale against which two summation orders are
    compared."""
    rng = np.random.RandomState(seed)

    def step(x):
        x = np.asarray(x, np.float32)
        to = np.where(rng.rand(*x.shape) < 0.5, -np.inf, np.inf)
        return np.nextafter(x, to.astype(np.float32))

    return tree_map(step, tree)


def same_gradients(report, ref, rtol=2e-4, leaf_rtol=2e-4,
                   zero_rtol=1e-5) -> list:
    """Where the gradients the optimizer got (:func:`run_steps`'s
    ``grads``) differ: the whole gradient beyond ``rtol`` of its norm, a
    leaf beyond ``leaf_rtol`` of the leaf's norm, or a
    :func:`zero_gradient_leaves` leaf whose gradient, in either run, is not
    float noise (above ``zero_rtol`` of the whole gradient's norm).
    Returns ``(name, relative error)`` pairs ("" for the whole)."""
    err = gradient_errors(report, ref)
    total = err[""][1]
    zero = zero_gradient_leaves(ref["params"])
    a = dict(_flat(report["grads"]))
    bad = [("", err[""][0])] if err[""][0] > rtol else []
    for k, (rel, n) in err.items():
        if not k:
            continue
        if k in zero:
            worst = max(n, float(np.linalg.norm(a[k])))
            if worst > zero_rtol * total:
                bad.append((k, worst / total))
        elif rel > leaf_rtol:
            bad.append((k, rel))
    return bad
