#!/usr/bin/env python3
"""Time block shapes of the port's attention kernel on one NVIDIA card.

    python3 tools/sweep_attention_tiles.py

Compiles ``subgc_tpu_torch/ops/csrc/attention.cu`` once per (threads per
block, queries per block, unroll of the projection loop) with
``-DSUBGC_ATT_THREADS/-DSUBGC_ATT_QUERIES/-DSUBGC_ATT_UNROLL`` (all ``nvcc``
runs started together), checks each build against the plain
PyTorch version, and prints the CUDA-event median time of each at the
inputs ``chip_smoke.py`` uses: the main path's 16-image batch (S=160) and a
96-image batch (S=960), both beam layouts.  The last line of the output is
the whole table as one JSON object.
"""
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from subgc_tpu_torch import build_configs, params_from_numpy  # noqa: E402
from subgc_tpu_torch.models.params import init_params_numpy  # noqa: E402
from subgc_tpu_torch.ops import _build  # noqa: E402
from subgc_tpu_torch.ops import attention as A  # noqa: E402

VARIANTS = [(t, q, u) for t in (256, 512, 1024) for q in (4, 8, 16)
            for u in (4, 16)]
SHAPES = [("image", 160, 16), ("subgraph", 160, 160), ("image", 960, 96),
          ("subgraph", 960, 960)]


def build_all(tmp):
    src = os.path.join(_build.CSRC, "attention.cu")
    procs = {}
    for t, q, u in VARIANTS:
        out = os.path.join(tmp, f"att_{t}_{q}_{u}.so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS,
               f"-DSUBGC_ATT_THREADS={t}", f"-DSUBGC_ATT_QUERIES={q}",
               f"-DSUBGC_ATT_UNROLL={u}", "-o", out, src]
        procs[(t, q, u)] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT,
                                               text=True))
    fns = {}
    for key, (out, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        fn = ctypes.CDLL(out).subgc_shared_attention_f32
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[key] = fn
    return fns


def launcher(fn, x):
    S, B, R, G, N, H, D = A._check(*x)
    out = torch.empty((S, B, D), device="cuda")
    w = torch.empty((S, B, N), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(*(t.data_ptr() for t in x), out.data_ptr(), w.data_ptr(),
                 S, B, R, G, N, H, D, stream)
        if err:
            raise RuntimeError(f"cudaError_t {err}")
    return run, out, w


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip()
    print(card)
    cfg, _, _ = build_configs("Sub_GC_Kar")
    params = params_from_numpy(init_params_numpy(cfg, seed=0)[0], "cuda")
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_all(tmp)
        rows = []
        for layout, S, G in SHAPES:
            x = cs.attention_inputs(params, layout, S, G, seed=0)
            r_out, r_w = A.shared_attention_ref(*x)
            plain = cs.cuda_ms(lambda: A.shared_attention_ref(*x))
            for key, fn in fns.items():
                run, out, w = launcher(fn, x)
                run()
                torch.cuda.synchronize()
                ok = bool((w - r_w).abs().max() <= 1e-5 and (
                    (out - r_out).abs()
                    <= 1e-4 + 1e-4 * r_out.abs()).all())
                ms = cs.cuda_ms(run)
                rows.append({"layout": layout, "S": S, "G": G,
                             "threads": key[0], "queries": key[1],
                             "unroll": key[2], "ms": ms, "plain_ms": plain, "ok": ok})
                print(f"{layout:8s} S={S:4d} threads={key[0]:4d} "
                      f"queries={key[1]:2d} unroll={key[2]:2d}: "
                      f"{ms:.4f} ms (plain "
                      f"{plain:.4f} ms) {'ok' if ok else 'WRONG'}")
    print(json.dumps({"card": card, "rows": rows}))
    if not all(r["ok"] for r in rows):
        sys.exit("a block shape disagrees with the plain version")


if __name__ == "__main__":
    main()
