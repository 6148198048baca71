#!/usr/bin/env python3
"""Where the port's test paths spend their time on one NVIDIA card.

    python3 tools/profile_torch_main_path.py [batch_images] [MODEL_TYPE]

Runs a test preset of ``chip_smoke.py`` (default Sub_GC_Kar: beam 2, NMS
0.75, keep 10; also Sub_GC_Flickr_GRD, Sub_GC_MRNN, Sub_GC_S_MRNN) at full
model width with random weights on bench-shaped synthetic images, bucket 128
(1024 for the keep-1000 fan-out presets), through ``make_batched_infer_fn``:
after a warm-up batch, five batches unprofiled (captions/s).  Then
``run_test_split`` over five batches of the same images, host work included
(stacking, transfers, caption text, the grounding collector under
Sub_GC_Flickr_GRD), and once more under ``cProfile`` for the host functions
that take the most time.  Then two batches under ``torch.profiler``: prints
the profiled window's wall time, the device's busy share (the sum of kernel
times over the wall time; one stream, so kernels do not overlap), the
kernel launches per batch, and the kernels and operators that take the most
device time.
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


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else cs.BATCH_IMAGES
    preset = sys.argv[2] if len(sys.argv) > 2 else "Sub_GC_Kar"
    cfg, ecfg, _ = build_configs(preset)
    bucket = cs.FANOUT_BUCKET if ecfg.gpn_max_subg > cs.BUCKET else cs.BUCKET
    ecfg = ecfg.replace(max_subgraph_bucket=bucket)
    pn, state = init_params_numpy(cfg, seed=0)
    params = params_from_numpy(pn, "cuda")
    infer = make_batched_infer_fn(cfg, ecfg)
    examples = cs.make_examples(cfg, batch, bucket)
    dev = torch.device("cuda")
    graph, subs = (to_device(x, dev) for x in _stack_examples(examples))
    infer(params, state, graph, subs)              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        out = infer(params, state, graph, subs)
        out["seq"].cpu()
    plain_ms = 1e3 * (time.perf_counter() - t0) / 5
    n_caps = int(out["keep_valid"].sum())

    loader = cs.MemoryLoader(examples * 5)
    vocab = {str(i): f"w{i}" for i in range(1, cfg.vocab_size + 1)}
    collector = (GroundingCollector(*cs.grounding_tables(vocab, examples))
                 if ecfg.return_att else None)
    split = dict(verbose=False, batch_images=batch, device="cuda",
                 collect_grounding=collector)
    _, split_s, split_caps = run_test_split(params, state, loader, cfg, ecfg,
                                            vocab, **split)
    host = cProfile.Profile()
    host.enable()
    run_test_split(params, state, loader, cfg, ecfg, vocab, **split)
    host.disable()
    host_top = io.StringIO()
    pstats.Stats(host, stream=host_top).sort_stats("tottime").print_stats(12)

    n_batches = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_batches):
            out = infer(params, state, graph, subs)
            out["seq"].cpu()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    avgs = prof.key_averages()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        sys.exit("the profiler recorded no device events")
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"{preset}, bucket {bucket}")
    print(f"unprofiled: {plain_ms:.2f} ms/batch of {batch} images, "
          f"{n_caps} captions/batch = {1e3 * n_caps / plain_ms:.1f} "
          f"captions/s")
    print(f"run_test_split: {1e3 * split_s / 5:.2f} ms/batch = "
          f"{split_caps / split_s:.1f} captions/s; host functions by own "
          f"time in a second run under cProfile:")
    print(host_top.getvalue())
    print(f"{n_batches} batches of {batch} images: wall {wall_ms:.2f} ms "
          f"({wall_ms / n_batches:.2f} ms/batch), device busy "
          f"{busy_ms:.2f} ms = {100 * busy_ms / wall_ms:.1f}% of wall, "
          f"{len(kernels) / n_batches:.0f} kernel launches/batch")
    print(avgs.table(sort_by="self_device_time_total", row_limit=20,
                     max_name_column_width=60))


if __name__ == "__main__":
    main()
