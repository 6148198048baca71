"""Training CLI — `python -m subgc_tpu_torch.cli.train <MODEL_TYPE> [flags]`.

The port's counterpart of ``subgc_tpu/cli/train.py``, with the same flags
plus ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).
MODEL_TYPE resolves to the five ``train.sh`` presets (``TRAIN_PRESETS``);
the loop mirrors `train.py:54-240`: warmup/decay LR, scheduled sampling
(the hoisted step while ss_prob is 0), the val loss and a checkpoint every
``save_checkpoint_every`` iterations and at the end, and an emergency
``_crash`` checkpoint on failure.  ``--start_from`` takes a checkpoint of
either package (``model.npz`` + ``infos.json``; the port's optimizer state
when its ``optimizer.npz`` matches, and an error when another ``--optim``
wrote it), with ``--word_mapping`` for a vocab remap.  ``--optim`` picks
any of the JAX package's five optimizers (``adam``, the presets',
``adamw``, ``sgd``, ``rmsprop``, ``adagrad``).
``--self_critical_after E`` trains with SCST (``train/scst.py``) from
epoch E on: each sentence's reward is its sample's CIDEr against its
image's GT captions minus its greedy baseline's.

As in the JAX loop, a producer thread (``data/prefetch.py``, depth 2)
assembles the next train batches under ``loader_lock`` and copies them to
the device while the step runs; the val batches come from the same loader
under the same lock.  ``PhaseTimers`` time the ``data``, ``step`` and
``scst_step`` phases and print their report at the end.  ``--trace_steps
START:COUNT`` writes a ``torch.profiler`` Chrome trace of those train
steps to ``<checkpoint_path>/trace/trace.json``.  ``--packed_path`` reads
packed shards (a path, a glob or a comma list) in place of ``--sg_dir`` /
``--mask_dir``.

``--compute_dtype bfloat16`` (with ``--bf16_lstm_gates`` and
``--bf16_residuals``) trains in the bf16 chain over float32 parameters and
Adam state, bf16 matmuls summing in float32; the checkpoint's
``model_config`` records it, so ``cli/test.py`` decodes it in bf16.

``--n_devices N`` trains data-parallel, one process per card over
``torch.distributed`` (NCCL on the cards, gloo on ``--device cpu``): by
default every attached card (on the CPU, 1), shrunk until it divides
``batch_size``, as in the JAX CLI.  With N > 1 and no process group yet
the CLI spawns N ranks on ``cuda:0..N-1`` (``parallel/launch.py``); a
process started by ``torchrun`` (with ``SUBGC_AUTO_DISTRIBUTED=1``) or with
``SUBGC_COORDINATOR`` / ``SUBGC_NUM_PROCESSES`` / ``SUBGC_PROCESS_ID`` set
joins that group instead (``parallel/distributed.py``).  Every rank
assembles the same global batch from the same seed and keeps its slice
(``train.step.local_train_batch``); the step is the global batch's
(``train/step.py``).  Rank 0 alone writes checkpoints, histories, metrics
and traces; the other ranks wait for it.  ``--start_from`` loads on every
rank.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import threading
import time

import numpy as np

from ..device import f32_accumulation


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model_type", nargs="?", default="Sub_GC_Kar")
    p.add_argument("--checkpoint_path", type=str, default="logs/run")
    p.add_argument("--start_from", type=str, default=None)
    p.add_argument("--auto_resume", type=int, default=0,
                   help="resume from checkpoint_path/model.npz if present")
    p.add_argument("--trace_steps", type=str, default=None,
                   help="'START:COUNT': a torch.profiler trace of those "
                        "train steps into checkpoint_path/trace")
    p.add_argument("--word_mapping", type=str, default=None,
                   help="word_mapping.npy for cross-dataset finetune: maps "
                        "new vocab index -> old (models/__init__.py:14-41)")
    p.add_argument("--max_iters", type=int, default=-1,
                   help="stop after N iterations (useful for smoke runs)")
    p.add_argument("--save_history_ckpt", type=int, default=0,
                   help="1: additionally keep an iteration-suffixed copy at "
                        "every checkpoint (reference opts.py:131)")
    p.add_argument("--self_critical_after", type=int, default=-1,
                   help="switch to self-critical training (SCST) from this "
                        "epoch on; -1 = never")
    p.add_argument("--optim", type=str, default=None,
                   choices=["adam", "adamw", "sgd", "rmsprop", "adagrad"],
                   help="optimizer (default: the preset's, adam)")
    p.add_argument("--max_epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--save_checkpoint_every", type=int, default=None)
    p.add_argument("--val_images_use", type=int, default=None)
    p.add_argument("--losses_log_every", type=int, default=None)
    p.add_argument("--input_json", type=str, default=None)
    p.add_argument("--input_label_h5", type=str, default=None)
    p.add_argument("--sg_dir", type=str, default=None)
    p.add_argument("--mask_dir", type=str, default=None)
    p.add_argument("--packed_path", type=str, default=None,
                   help="packed shard(s) (glob / comma-list) replacing "
                        "--sg_dir/--mask_dir")
    p.add_argument("--glove_path", type=str, default=None)
    p.add_argument("--obj_name_path", type=str, default=None)
    p.add_argument("--rel_name_path", type=str, default=None)
    p.add_argument("--n_devices", type=int, default=None,
                   help="data-parallel ranks, one per card (default: every "
                        "attached card, 1 on the CPU, shrunk until it "
                        "divides batch_size)")
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=["float32", "bfloat16"],
                   help="matmul compute dtype (params and optimizer stay "
                        "float32)")
    p.add_argument("--bf16_lstm_gates", type=int, default=None,
                   help="with bfloat16: run the [S,4R] LSTM gate streams in "
                        "bf16 too (c stays float32)")
    p.add_argument("--bf16_residuals", type=int, default=None,
                   help="store the LSTM's saved-for-backward residuals in "
                        "bf16 (forward unchanged)")
    p.add_argument("--share_att_train", type=int, default=None,
                   help="teacher-forced attention over image-shared node "
                        "streams instead of per-row gathered copies")
    p.add_argument("--use_bn", type=int, default=None, choices=[0, 1, 2],
                   help="att_embed BatchNorm (opts.py:46-47)")
    p.add_argument("--gcn_layers", type=int, default=None)
    p.add_argument("--gcn_residual", type=int, default=None)
    p.add_argument("--gcn_bn", type=int, default=None)
    p.add_argument("--gcn_dim", type=int, default=None)
    p.add_argument("--rnn_size", type=int, default=None)
    p.add_argument("--att_hid_size", type=int, default=None)
    p.add_argument("--input_encoding_size", type=int, default=None)
    p.add_argument("--pred_emb_type", type=int, default=None, choices=[1, 2])
    p.add_argument("--drop_prob_lm", type=float, default=None)
    p.add_argument("--seed", type=int, default=2019)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def _n_devices(args, dev, batch_size: int) -> int:
    """The data-parallel rank count: ``--n_devices``, by default every
    attached card (1 on the CPU), shrunk until it divides the batch (the
    JAX CLI's rule)."""
    import torch
    avail = torch.cuda.device_count() if dev.type == "cuda" else None
    n = args.n_devices or (avail or 1)
    if avail is not None and n > avail:
        raise SystemExit(f"--n_devices {n} > {avail} attached devices")
    while n > 1 and batch_size % n:
        n -= 1          # the data axis must divide the batch
    return n


def _rank_main(rank, world, device, startup, argv):
    """A spawned rank: the CLI again, inside the process group, on its
    device."""
    main(list(argv) + ["--device", str(device)])


def _overrides(args):
    overrides = {"train": {}, "data": {}, "model": {}}
    for k in ["max_epochs", "batch_size", "learning_rate",
              "save_checkpoint_every", "val_images_use", "losses_log_every",
              "optim"]:
        if getattr(args, k) is not None:
            overrides["train"][k] = getattr(args, k)
    for k in ["input_json", "input_label_h5", "sg_dir", "mask_dir",
              "packed_path", "glove_path", "obj_name_path", "rel_name_path"]:
        if getattr(args, k) is not None:
            overrides["data"][k] = getattr(args, k)
    for k in ["compute_dtype", "use_bn", "gcn_layers", "gcn_residual",
              "gcn_dim", "rnn_size", "att_hid_size", "input_encoding_size",
              "pred_emb_type", "drop_prob_lm"]:
        if getattr(args, k) is not None:
            overrides["model"][k] = getattr(args, k)
    for k in ["bf16_lstm_gates", "bf16_residuals", "share_att_train",
              "gcn_bn"]:
        if getattr(args, k) is not None:
            overrides["model"][k] = bool(getattr(args, k))
    return overrides


@f32_accumulation()          # bf16 matmuls sum in float32, as in JAX
def main(argv=None):
    args = parse_args(argv)

    import torch
    import torch.distributed as dist

    from ..config import build_configs, config_to_json
    from ..data.dataset import TrainLoader
    from ..data.prefetch import BatchPrefetcher
    from ..device import resolve_device
    from ..models import setup_numpy
    from ..models.params import params_from_numpy
    from ..parallel import distributed as DP
    from ..parallel import launch
    from ..train import checkpoint as C
    from ..train.optim import OptState, ss_prob
    from ..train.step import (batch_to_device, init_train_state,
                              local_train_batch, make_train_step,
                              make_val_step)
    from ..utils.logging import MetricsLogger
    from ..utils.profiling import PhaseTimers, device_trace

    dev = resolve_device(args.device)
    mcfg, tcfg, dcfg = build_configs(args.model_type, mode="train",
                                     **_overrides(args))
    joined = DP.maybe_initialize_distributed()
    if joined:
        world, rank = dist.get_world_size(), dist.get_rank()
        if args.n_devices and args.n_devices != world:
            raise SystemExit(f"--n_devices {args.n_devices} in a process "
                             f"group of {world}")
        if tcfg.batch_size % world:
            raise SystemExit(f"--batch_size {tcfg.batch_size} must be "
                             f"divisible by the {world} ranks")
        if dev.type == "cuda" and dev.index is None:
            dev = DP.rank_device("cuda")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
    else:
        world, rank = _n_devices(args, dev, tcfg.batch_size), 0
        if world > 1:
            argv = list(sys.argv[1:] if argv is None else argv)
            devices = ([torch.device("cuda", i) for i in range(world)]
                       if dev.type == "cuda" else [dev] * world)
            launch.spawn(_rank_main, world, devices,
                         args=(argv + ["--n_devices", str(world)],))
            with open(os.path.join(args.checkpoint_path,
                                   "infos.json")) as f:
                infos = json.load(f)
            return {"iter": infos["iter"], "epoch": infos["epoch"]}
    group = dist.group.WORLD if world > 1 else None
    lead = rank == 0            # writes checkpoints, logs and traces
    log = print if lead else (lambda *a, **k: None)
    loader = TrainLoader(mcfg, tcfg, dcfg, seed=args.seed)
    mcfg = mcfg.replace(vocab_size=loader.vocab_size,
                        seq_length=loader.seq_length)

    iteration, epoch = 0, 0
    histories = {"loss_history": {}, "lr_history": {}, "ss_prob_history": {},
                 "val_loss_history": {}}
    opt_np = None

    if (args.auto_resume and not args.start_from
            and os.path.exists(os.path.join(args.checkpoint_path,
                                            "model.npz"))):
        args.start_from = args.checkpoint_path
        log(f"auto-resuming from {args.checkpoint_path}")
    wm = None
    if args.start_from and args.word_mapping:
        wm = np.load(args.word_mapping, allow_pickle=True, encoding="latin1")
    params_np, state_np, loaded = setup_numpy(
        mcfg, dcfg, seed=args.seed, start_from=args.start_from,
        word_mapping=wm, optim=tcfg.optim)
    if loaded is not None:
        opt_np, infos, histories2 = loaded
        iteration = infos.get("iter", 0)
        epoch = infos.get("epoch", 0)
        histories = histories2 or histories

    ts = init_train_state(params_from_numpy(params_np, dev, True),
                          params_from_numpy(state_np, dev), tcfg,
                          step=iteration)
    if opt_np is not None:
        ts = ts._replace(opt_state=OptState(
            kind=opt_np.kind, count=opt_np.count,
            moments=params_from_numpy(opt_np.moments, dev)))

    # the ss-inactive step hoists the word-embedding gate products out of
    # the step loop; a run that never reaches scheduled sampling uses only
    # that one
    step_ss = make_train_step(mcfg, tcfg, group=group)
    step_hoisted = make_train_step(mcfg, tcfg, ss_active=False, group=group)
    val_step = make_val_step(mcfg, group)
    scst_fns = None
    if args.self_critical_after >= 0:
        from ..train.scst import (make_sample_fn, make_scst_update_fn,
                                  scst_train_step)
        scst_fns = (make_sample_fn(mcfg, group),
                    make_scst_update_fn(mcfg, tcfg, group))
    # one seed on every rank: the draws are the global batch's
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    if lead:
        os.makedirs(args.checkpoint_path, exist_ok=True)
    infos_base = {
        "model_config": config_to_json(mcfg),
        "train_config": config_to_json(tcfg),
        "data_config": config_to_json(dcfg),
        "model_type": args.model_type,
        "vocab": loader.vocab,
    }

    def save(suffix="", wait=True):
        # every rank holds the same params; rank 0 writes them
        if lead:
            infos = dict(infos_base, iter=iteration, epoch=epoch)
            C.save_checkpoint(args.checkpoint_path, ts.params,
                              ts.model_state, ts.opt_state, infos, histories,
                              suffix=suffix)
            print(f"checkpoint saved to {args.checkpoint_path}"
                  f"{suffix or ''} at iter {iteration}")
        if group is not None and wait:
            dist.barrier(group)

    log(f"training {args.model_type}: vocab {mcfg.vocab_size}, "
        f"{len(loader.split_ix['train'])} train images, "
        f"batch {tcfg.batch_size}, {mcfg.compute_dtype}, device {dev}"
        + (f", rank 0 of {world}" if group is not None else ""))
    timers = PhaseTimers()
    loader_lock = threading.Lock()   # val batches share the loader state

    def _next_train():
        with loader_lock:
            return loader.get_batch("train")

    def place(b):
        # every rank assembles the global batch and keeps its slice
        return batch_to_device(local_train_batch(b, rank, world), dev,
                               non_blocking=dev.type == "cuda")

    prefetch = BatchPrefetcher(_next_train, depth=2, device=dev, place=place)
    metrics_log = MetricsLogger(args.checkpoint_path) if lead else None
    trace_dir = os.path.join(args.checkpoint_path, "trace")
    trace_start = trace_stop = -1
    if args.trace_steps and lead:
        a, b = args.trace_steps.split(":")
        trace_start, trace_stop = int(a), int(a) + int(b)
    trace = contextlib.ExitStack()
    t_start = time.time()
    n_steps = 0
    try:
        while True:
            sp = ss_prob(epoch, tcfg)
            if iteration == trace_start:
                trace.enter_context(device_trace(trace_dir))
            with timers.phase("data"):
                batch, (infos_b, wrapped) = prefetch.next()
            if scst_fns is not None and epoch >= args.self_critical_after:
                # each sentence is scored against its image's GT captions
                # (the global batch's, on every rank)
                gts_tokens = [loader.ds.captions_for(info.ix)
                              for info in infos_b
                              for _ in range(tcfg.seq_per_img)]
                with timers.phase("scst_step"):
                    ts, scst_loss, mean_reward = scst_train_step(
                        ts, batch, gts_tokens, loader.vocab, *scst_fns,
                        generator, epoch, group)
                zero = torch.zeros((), device=dev)
                metrics = {"loss": torch.tensor(scst_loss),
                           "lang_loss": torch.tensor(scst_loss),
                           "gpn_loss": zero, "lr": zero, "grad_norm": zero}
                if iteration % 5 == 0:
                    log(f"scst iter {iteration}: loss {scst_loss:.4f} "
                        f"mean reward {mean_reward:.4f}")
            else:
                step = step_hoisted if sp == 0.0 else step_ss
                with timers.phase("step"):
                    ts, metrics = step(ts, batch, generator, epoch, sp)
            iteration += 1
            n_steps += 1
            if iteration == trace_stop:
                trace.close()
                log(f"device trace ({trace_start}:{trace_stop}) -> "
                    f"{trace_dir}")

            if iteration % tcfg.losses_log_every == 0 or iteration % 5 == 0:
                m = {k: float(v) for k, v in metrics.items()}
            if iteration % tcfg.losses_log_every == 0:
                histories["loss_history"][str(iteration)] = m["loss"]
                histories["lr_history"][str(iteration)] = m["lr"]
                histories["ss_prob_history"][str(iteration)] = sp
                if lead:
                    metrics_log.log(iteration, {
                        "train_loss": m["loss"], "gpn_loss": m["gpn_loss"],
                        "lang_loss": m["lang_loss"], "learning_rate": m["lr"],
                        "scheduled_sampling_prob": sp,
                        "grad_norm": m["grad_norm"]})
            if iteration % 5 == 0:
                log(f"iter {iteration} (ep {epoch}): gpn "
                    f"{m['gpn_loss']:.3f} lang {m['lang_loss']:.3f} loss "
                    f"{m['loss']:.3f} lr {m['lr']:.2e} "
                    f"({(time.time() - t_start) / n_steps:.3f}s/it)")
            if wrapped:
                epoch += 1

            done = ((tcfg.max_epochs >= 0 and epoch >= tcfg.max_epochs)
                    or (args.max_iters > 0 and iteration >= args.max_iters))
            if iteration % tcfg.save_checkpoint_every == 0 or done:
                # quick val loss (eval_utils.py:73-86)
                vloss, nval = 0.0, 0
                loader.reset_iterator("val")
                max_val = tcfg.val_images_use // tcfg.batch_size
                for _ in range(max(1, min(2, max_val))):
                    with loader_lock:
                        vb, _, vw = loader.get_batch("val")
                    vb = local_train_batch(vb, rank, world)
                    vloss += float(val_step(ts.params, ts.model_state,
                                            batch_to_device(vb, dev)))
                    nval += 1
                    if vw:
                        break
                histories["val_loss_history"][str(iteration)] = \
                    vloss / max(nval, 1)
                if lead:
                    metrics_log.log(iteration,
                                    {"val_loss": vloss / max(nval, 1)})
                log(f"val loss {vloss / max(nval, 1):.3f}")
                save()
                if args.save_history_ckpt:
                    save(suffix=f"-{iteration}")
                if done:
                    break
    except KeyboardInterrupt:
        # emergency checkpoint on interruption (the reference just prints a
        # traceback and exits, train.py:233-235)
        print(f"interrupted at iter {iteration}; saving emergency checkpoint")
        save(suffix="_crash", wait=False)
        raise SystemExit(1)
    except Exception:
        import traceback
        traceback.print_exc()
        print(f"training failed at iter {iteration}; saving emergency "
              f"checkpoint")
        save(suffix="_crash", wait=False)
        raise
    finally:
        prefetch.stop()
        trace.close()
        if metrics_log is not None:
            metrics_log.close()
    log(timers.report())
    log(f"done at iter {iteration}, epoch {epoch}")
    return {"iter": iteration, "epoch": epoch}


if __name__ == "__main__":
    main()
