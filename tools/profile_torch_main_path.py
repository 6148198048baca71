#!/usr/bin/env python3
"""Where the port's test paths spend their time on one NVIDIA card.

    python3 tools/profile_torch_main_path.py [batch_images] [MODEL_TYPE]
    python3 tools/profile_torch_main_path.py train [MODEL_TYPE]

Either form takes ``--compute_dtype bfloat16``: the bf16 chain with bf16
LSTM gate streams (and, in training, bf16 backward residuals), the
configuration bench.py runs; bf16 matmuls sum in float32.

Runs a test preset of ``chip_smoke.py`` (default Sub_GC_Kar: beam 2, NMS
0.75, keep 10; any of the eight) at full model width with random weights on
bench-shaped synthetic images, bucket 128 (1024 for the keep-1000 fan-out
presets; the SCT presets take ``chip_smoke.py``'s region-set images at
bucket 32), through ``make_batched_infer_fn`` (Full_GC_Kar, which has no
batched route: ``encode_image`` + ``beam_search`` image by image, with
BatchNorm statistics drawn from a seed): after a warm-up batch, five
batches unprofiled (captions/s).  Then ``run_test_split`` over five batches
of the same images, host work included (stacking, transfers, caption text,
the grounding collector under Sub_GC_Flickr_GRD), and once more under
``cProfile`` for the host functions that take the most time (Full_GC_Kar:
the image-by-image decode under ``cProfile``).  Then two batches under
``torch.profiler``: prints the profiled window's wall time, the device's
busy share (the sum of kernel times over the wall time; one stream, so
kernels do not overlap), the kernel launches per batch, and the kernels and
operators that take the most device time.

``train`` profiles the train step of a train preset (default Sub_GC_Kar)
at full width at the preset's batch (64 images, 100 for Full_GC_Kar) on
``chip_smoke.py``'s synthetic train batch, dropout on, the hoisted step
past the LR warmup: after two warm-up steps, ms per step over five steps
unprofiled (images/s) and the peak memory; then two steps under
``torch.profiler``: wall, device busy share, kernel launches per step and
the kernels that take the most device time.
"""
import cProfile
import io
import os
import pstats
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from subgc_tpu_torch import (GroundingCollector, build_configs,  # noqa: E402
                             make_batched_infer_fn, params_from_numpy,
                             run_test_split)
from subgc_tpu_torch.eval.runner import _stack_examples  # noqa: E402
from subgc_tpu_torch.graph import to_device  # noqa: E402
from subgc_tpu_torch.models.params import init_params_numpy  # noqa: E402


def _print_profile(prof, wall_ms, n, unit):
    """Busy share, launches per ``unit`` and the top kernels of a
    profiled window of ``n`` units."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        sys.exit("the profiler recorded no device events")
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(f"{n} {unit}s: wall {wall_ms:.2f} ms ({wall_ms / n:.2f} ms/{unit}), "
          f"device busy {busy_ms:.2f} ms = {100 * busy_ms / wall_ms:.1f}% "
          f"of wall, {len(kernels) / n:.0f} kernel launches/{unit}")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=20, max_name_column_width=60))


def dtype_overrides(dtype, train=False):
    """build_configs' model overrides for ``--compute_dtype``."""
    if dtype == "float32":
        return {}
    return dict(compute_dtype=dtype, bf16_lstm_gates=True,
                **(dict(bf16_residuals=True) if train else {}))


def profile_train(preset, dtype):
    from subgc_tpu_torch.data.synthetic import synthetic_train_batch
    from subgc_tpu_torch.train.step import (batch_to_device,
                                            init_train_state,
                                            make_train_step)
    cfg, tcfg, _ = build_configs(preset, mode="train",
                                 model=dtype_overrides(dtype, train=True))
    dev = torch.device("cuda")
    pn, state = init_params_numpy(cfg, seed=0)
    ts = init_train_state(params_from_numpy(pn, dev, requires_grad=True),
                          params_from_numpy(state, dev), tcfg,
                          step=tcfg.warmup_n + 1)
    batch = batch_to_device(synthetic_train_batch(cfg, tcfg.batch_size,
                                                  seed=0), dev)
    step = make_train_step(cfg, tcfg, ss_active=False)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(2):                              # warm-up
        ts, m = step(ts, batch, gen, 0, 0.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(5):
        ts, m = step(ts, batch, gen, 0, 0.0)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / 5
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"{preset} train step, {cfg.compute_dtype}, {tcfg.batch_size} "
          f"images ({5 * tcfg.batch_size} sentences, "
          f"{cfg.seq_length + 1} steps): unprofiled {ms:.2f} ms/step = "
          f"{tcfg.batch_size * 1e3 / ms:.1f} images/s; loss "
          f"{m['loss'].item():.4f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            ts, m = step(ts, batch, gen, 0, 0.0)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    _print_profile(prof, wall_ms, 2, "step")


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    argv = sys.argv[1:]
    dtype = "float32"
    if "--compute_dtype" in argv:
        i = argv.index("--compute_dtype")
        dtype = argv[i + 1]
        del argv[i:i + 2]
    if argv and argv[0] == "train":
        profile_train(argv[1] if len(argv) > 1 else "Sub_GC_Kar", dtype)
        return
    batch = int(argv[0]) if argv else cs.BATCH_IMAGES
    preset = argv[1] if len(argv) > 1 else "Sub_GC_Kar"
    cfg, ecfg, _ = build_configs(preset, model=dtype_overrides(dtype))
    if ecfg.sct:
        bucket = cs.SCT_BUCKET
    elif ecfg.gpn_max_subg > cs.BUCKET:
        bucket = cs.FANOUT_BUCKET
    else:
        bucket = cs.BUCKET
    ecfg = ecfg.replace(max_subgraph_bucket=bucket)
    pn, state = init_params_numpy(cfg, seed=0)
    if not cfg.use_gpn:
        state = cs.bn_state_from_seed(state, seed=11)
    params, state = (params_from_numpy(t, "cuda") for t in (pn, state))
    if ecfg.sct:
        examples = cs.make_sct_examples(cfg, batch, bucket, seed=21,
                                        gt=ecfg.use_gt_subg)
    else:
        examples = cs.make_examples(cfg, batch, bucket)
    dev = torch.device("cuda")
    if cfg.use_gpn:
        infer = make_batched_infer_fn(cfg, ecfg)
        graph, subs = (to_device(x, dev) for x in _stack_examples(examples))

        def run_batch():
            out = infer(params, state, graph, subs)
            out["seq"].cpu()
            return int(out["keep_valid"].sum())
    else:
        def run_batch():
            cs.decode_fullgc(params, state, examples, cfg, ecfg, dev)
            return len(examples)
    run_batch()                                    # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        n_caps = run_batch()
    plain_ms = 1e3 * (time.perf_counter() - t0) / 5

    loader = cs.MemoryLoader(examples * 5)
    vocab = {str(i): f"w{i}" for i in range(1, cfg.vocab_size + 1)}
    collector = (GroundingCollector(*cs.grounding_tables(vocab, examples))
                 if ecfg.return_att else None)
    split = dict(verbose=False, batch_images=batch, device="cuda",
                 collect_grounding=collector)
    host = cProfile.Profile()
    if cfg.use_gpn:
        _, split_s, split_caps = run_test_split(params, state, loader, cfg,
                                                ecfg, vocab, **split)
        host.enable()
        run_test_split(params, state, loader, cfg, ecfg, vocab, **split)
    else:
        host.enable()
        run_batch()
    host.disable()
    host_top = io.StringIO()
    pstats.Stats(host, stream=host_top).sort_stats("tottime").print_stats(12)

    n_batches = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_batches):
            run_batch()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"{preset}, {cfg.compute_dtype}, bucket {bucket}")
    print(f"unprofiled: {plain_ms:.2f} ms/batch of {batch} images, "
          f"{n_caps} captions/batch = {1e3 * n_caps / plain_ms:.1f} "
          f"captions/s")
    if cfg.use_gpn:
        print(f"run_test_split: {1e3 * split_s / 5:.2f} ms/batch = "
              f"{split_caps / split_s:.1f} captions/s; host functions by "
              f"own time in a second run under cProfile:")
    else:
        print("no run_test_split route for Full-GC; host functions by own "
              "time in one batch under cProfile:")
    print(host_top.getvalue())
    print(f"batches of {batch} images:")
    _print_profile(prof, wall_ms, n_batches, "batch")


if __name__ == "__main__":
    main()
