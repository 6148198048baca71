#!/usr/bin/env python3
"""Where the port's main path spends its time on one NVIDIA card.

    python3 tools/profile_torch_main_path.py [batch_images]

Runs the Sub_GC_Kar test path of ``chip_smoke.py`` (full model width, beam
2, NMS 0.75, keep 10, bucket 128, random weights, bench-shaped synthetic
images) through ``make_batched_infer_fn``: after a warm-up batch, five
batches unprofiled (captions/s), then two under ``torch.profiler``.  Prints
the profiled window's wall time, the device's busy share (the sum of kernel
times over the wall time; one stream, so kernels do not overlap), the
kernel launches per batch, and the kernels and operators that take the most
device time.
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from subgc_tpu_torch import (build_configs, make_batched_infer_fn,  # noqa: E402
                             params_from_numpy)
from subgc_tpu_torch.eval.runner import _stack_examples  # noqa: E402
from subgc_tpu_torch.graph import to_device  # noqa: E402
from subgc_tpu_torch.models.params import init_params_numpy  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else cs.BATCH_IMAGES
    cfg, ecfg, _ = build_configs("Sub_GC_Kar",
                                 eval=dict(max_subgraph_bucket=cs.BUCKET))
    pn, state = init_params_numpy(cfg, seed=0)
    params = params_from_numpy(pn, "cuda")
    infer = make_batched_infer_fn(cfg, ecfg)
    examples = cs.make_examples(cfg, batch, cs.BUCKET)
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
    print(f"unprofiled: {plain_ms:.2f} ms/batch of {batch} images, "
          f"{n_caps} captions/batch = {1e3 * n_caps / plain_ms:.1f} "
          f"captions/s")
    print(f"{n_batches} batches of {batch} images: wall {wall_ms:.2f} ms "
          f"({wall_ms / n_batches:.2f} ms/batch), device busy "
          f"{busy_ms:.2f} ms = {100 * busy_ms / wall_ms:.1f}% of wall, "
          f"{len(kernels) / n_batches:.0f} kernel launches/batch")
    print(avgs.table(sort_by="self_device_time_total", row_limit=20,
                     max_name_column_width=60))


if __name__ == "__main__":
    main()
