#!/usr/bin/env python3
"""Time launch plans of the port's attention kernels on one NVIDIA card.

    python3 tools/sweep_attention_tiles.py [TABLE.json]

The plan's knobs are arguments of the kernels' C entry points, so one build
of ``subgc_tpu_torch/ops/csrc/attention.cu`` serves every variant:

* the projection's tiles, bm x bn queries x columns (bm in 32, 64, 128;
  bn in 64, 128), and its k split (1, 2, 3, 4, 6, 8; trimmed so that no
  split is empty), at the default rows per block;
* rows per attention block (queries per block = rows x beams <= 16), at the
  default projection, where rows share streams.

Each variant is checked against the plain PyTorch version (weights atol
1e-5, att_res rtol / atol 1e-4) and timed (CUDA-event median, warm L2) at
the inputs ``chip_smoke.py`` uses: both Kar beam layouts at S=160 and 960,
the M-RNN fan-out (S=2000 rows over 2 images, one beam) and the per-row
kernel at R=160 and 960.  Prints the default plan's time and the fastest
plan per shape; the last line is the fastest plan per shape as one JSON
object.  With a path, the whole table is also written there as JSON.
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from subgc_tpu_torch import build_configs, params_from_numpy  # noqa: E402
from subgc_tpu_torch.models.params import init_params_numpy  # noqa: E402
from subgc_tpu_torch.ops import attention as A  # noqa: E402

# (label, layout, S or R, G, beams)
SHAPES = [("Kar image S=160", "image", 160, 16, 2),
          ("Kar subgraph S=160", "subgraph", 160, 160, 2),
          ("Kar image S=960", "image", 960, 96, 2),
          ("Kar subgraph S=960", "subgraph", 960, 960, 2),
          ("fan-out S=2000", "image", 2000, 2, 1),
          ("row R=160", "row", 160, 160, 1),
          ("row R=960", "row", 960, 960, 1)]
SPLITS = (1, 2, 3, 4, 6, 8)


def shape_inputs(params, layout, S, G, beams, seed):
    if layout != "row":
        return cs.attention_inputs(params, layout, S, G, seed, beams)
    x = cs.attention_inputs(params, "subgraph", S, S, seed, 1)
    return [x[0][:, 0].contiguous(), *x[1:4], *x[5:]]


def plans(S, G, beams, Hin, H):
    default = A.attention_plan(S, beams, G, Hin, H)
    seen = {default}
    for bm in A.TILE_ROWS:
        for bn in A.TILE_COLS:
            for splits in SPLITS:
                p = A.project_plan(S * beams, Hin, H, bm=bm, bn=bn,
                                   splits=splits)._replace(
                    rows_per_block=default.rows_per_block)
                seen.add(p)
    rpb = 1
    while rpb * beams <= A.MAX_QUERIES_PER_BLOCK and G < S:
        seen.add(default._replace(rows_per_block=rpb))
        rpb *= 2
    return default, sorted(seen)


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
    rows, best = [], {}
    for label, layout, S, G, beams in SHAPES:
        x = shape_inputs(params, layout, S, G, beams, seed=0)
        Hin, H = x[-4].shape
        ref_fn = A.row_attention_ref if layout == "row" \
            else A.shared_attention_ref
        run_fn = A.run_row_attention if layout == "row" \
            else A.run_shared_attention
        r_out, r_w = ref_fn(*x)
        default, variants = plans(S, G, beams, Hin, H)
        for plan in variants:
            out, w = run_fn(x, plan)
            torch.cuda.synchronize()
            ok = bool((w - r_w).abs().max() <= 1e-5 and (
                (out - r_out).abs() <= 1e-4 + 1e-4 * r_out.abs()).all())
            ms = cs.cuda_ms(lambda: run_fn(x, plan))
            row = {"shape": label, **plan._asdict(), "ms": ms, "ok": ok,
                   "default": plan == default}
            rows.append(row)
            print(f"{label:20s} {plan}: {ms:.4f} ms"
                  f"{' (default)' if plan == default else ''}"
                  f"{'' if ok else ' WRONG'}")
        mine = [r for r in rows if r["shape"] == label and r["ok"]]
        best[label] = min(mine, key=lambda r: r["ms"])
        dflt = next(r for r in mine if r["default"])
        print(f"{label}: default {dflt['ms']:.4f} ms, fastest "
              f"{best[label]['ms']:.4f} ms at bm={best[label]['bm']} "
              f"bn={best[label]['bn']} splits={best[label]['splits']} "
              f"rows_per_block={best[label]['rows_per_block']}")
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump({"card": card, "rows": rows, "fastest": best}, f,
                      indent=1)
    print(json.dumps({"card": card, "fastest": best}))
    if not all(r["ok"] for r in rows):
        sys.exit("a plan disagrees with the plain version")


if __name__ == "__main__":
    main()
