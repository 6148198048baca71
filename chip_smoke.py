#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (subgc_tpu_torch) on one NVIDIA card, check it
and time it.  Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. device: the card's name and power limit (nvidia-smi); TF32 off, since the
   reference is full float32;
2. build: every kernel of the main path from ``subgc_tpu_torch/ops/csrc``;
3. kernel against its plain version on the card, float32, both beam layouts,
   at the main path's shape and at a 96-image batch (S=960 rows);
   tolerances: weights atol 1e-5, att_res rtol 1e-4 / atol 1e-4 (float32
   summation order);
4. the Sub_GC_Kar main path at full model width (``ModelConfig()`` defaults,
   beam 2, NMS 0.75, keep 10, bucket 128) with random weights from a seed, on
   synthetic images shaped like ``bench.py``'s, through ``run_test_split``;
   every kernel must have launched exactly dispatches x seq_length times;
5. the card against the CPU (plain attention) on the first image batch:
   identical keep sets, >= 95% identical captions, sGPN scores within rtol
   1e-4 (a float near-tie in a beam step may flip a word).

Prints a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``
as the last line.  Needs no network and imports no jax.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N_IMAGES = 64            # 4 dispatches of 16 images
BATCH_IMAGES = 16
BUCKET = 128
F32_PEAK = 67e12         # H100 SXM float32 outside the tensor cores, FLOP/s
HBM_RATE = 3.35e12       # H100 SXM device memory, bytes/s


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, runs=25, warmup=3):
    """Median device time of ``fn()`` over ``runs`` CUDA-event pairs, warm
    L2.  A spin kernel holds the card while the host enqueues every run, so
    the events time the device's work and not the host's launch overhead."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    torch.cuda._sleep(100_000_000)          # ~50 ms of device time
    for a, b in events:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def attention_bound_ms(S, B, R, G, N, H, D):
    """Least time for one launch: compulsory bytes over HBM rate against
    operations over the float32 peak (a multiply-add counts 2).
    Returns (ms, "bytes" or "operations")."""
    nbytes = 4 * (S * B * R + G * N * (H + D) + S * N + S + R * H + 2 * H + 1
                  + S * B * (D + N))
    ops = S * B * (2 * R * H + 2 * N * H + 2 * N * D)
    t_bytes, t_ops = nbytes / HBM_RATE, ops / F32_PEAK
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def attention_inputs(params, layout, S, G, seed):
    """Kernel inputs at full width: h in (-1, 1) like an LSTM output, the
    model's own h2att/alpha_net weights, projected node streams."""
    import torch
    dec = params["decoder"]
    dev = dec["h2att"]["w"].device
    n, R = 37, dec["h2att"]["w"].shape[0]
    H, D = dec["h2att"]["w"].shape[1], dec["att_embed"]["w"].shape[1]
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = G if layout == "image" else S
    h = torch.rand((S, 2, R), generator=g, device=dev) * 2 - 1
    p_att = torch.randn((rows, n, H), generator=g, device=dev) * 0.5
    att = torch.rand((rows, n, D), generator=g, device=dev)
    if layout == "image":
        # node-set membership over each row's image nodes
        mask = (torch.rand((S, n), generator=g, device=dev) < 0.2).float()
        idx = torch.repeat_interleave(torch.arange(G, device=dev), S // G)
    else:
        # left-packed sub-graph node slots
        count = torch.randint(3, 12, (S, 1), generator=g, device=dev)
        mask = (torch.arange(n, device=dev)[None] < count).float()
        idx = torch.arange(S, device=dev)
    mask[:, 0] = 1.0
    return [h, p_att, att, mask, idx.to(torch.int32), dec["h2att"]["w"],
            dec["h2att"]["b"], dec["alpha_net"]["w"], dec["alpha_net"]["b"]]


def check_attention(params, layout, S, G, seed=0):
    """Kernel against its plain version on the card; times both."""
    from subgc_tpu_torch.ops import attention as A
    x = attention_inputs(params, layout, S, G, seed)
    out, w = A.shared_attention(*x)
    r_out, r_w = A.shared_attention_ref(*x)
    w_err = (w - r_w).abs().max().item()
    o_err = (out - r_out).abs()
    bad = (o_err > 1e-4 + 1e-4 * r_out.abs()).sum().item()
    if not (w_err <= 1e-5 and bad == 0):
        fail(f"attention kernel ({layout}, S={S}) disagrees with its plain "
             f"version: max |dw| {w_err:.3g}, {bad} att_res entries out of "
             f"rtol/atol 1e-4")
    S_, B, R = x[0].shape
    G_, N, H = x[1].shape
    bound, by = attention_bound_ms(S_, B, R, G_, N, H, x[2].shape[-1])
    res = {"layout": layout, "S": S, "G": G,
           "max_abs_err": max(w_err, o_err.max().item()),
           "ms": cuda_ms(lambda: A.shared_attention(*x)),
           "plain_ms": cuda_ms(lambda: A.shared_attention_ref(*x)),
           "bound_ms": bound, "bound_by": by}
    print(f"attention kernel {layout:8s} S={S:4d} G={G:4d}: "
          f"kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
          f"bound {bound:.4f} ms ({by}), max |err| {res['max_abs_err']:.3g}")
    return res


def make_examples(cfg, n_images, bucket, seed=0):
    """Synthetic test images in the shape of bench.py's ``make_image``."""
    from subgc_tpu_torch.data.dataset import ImageInfo, TestExample
    from subgc_tpu_torch.graph import SceneGraph, SubgraphSet
    rng = np.random.RandomState(seed)
    N, K = cfg.obj_num, cfg.rel_num
    out = []
    for i in range(n_images):
        graph = SceneGraph(
            obj_fmap=rng.rand(1, N, cfg.att_feat_size).astype("f"),
            obj_dist=rng.rand(1, N, cfg.num_obj_classes).astype("f"),
            rel_ind=rng.randint(0, N - 1, (1, K, 2)).astype(np.int32),
            pred_dist=rng.rand(1, K, cfg.num_rel_classes).astype("f"))
        obj_ind = np.full((bucket, N), N - 1, np.int32)
        att_mask = np.zeros((bucket, N), np.float32)
        for s in range(bucket):
            n = rng.randint(3, 12)
            obj_ind[s, :n] = rng.choice(N - 1, n, replace=False)
            att_mask[s, :n] = 1
        subs = SubgraphSet(obj_ind=obj_ind,
                           pred_ind=np.full((bucket, K), K - 1, np.int32),
                           att_mask=att_mask, valid=np.ones((bucket,), bool))
        out.append(TestExample(graph=graph, subs=subs, n_subgraphs=bucket,
                               info=ImageInfo(ix=i, id=i, file_path=""),
                               gts=np.zeros((0, cfg.seq_length), np.int64),
                               sg_raw={}))
    return out


class MemoryLoader:
    """``iter_split`` over in-memory examples (the runner's loader contract)."""

    def __init__(self, examples):
        self.examples = examples

    def iter_split(self, split="test", num_images=-1):
        n = len(self.examples) if num_images < 0 else num_images
        return iter(self.examples[:n])


def check_predictions(preds, n_images, keep):
    if len(preds) != n_images:
        fail(f"{len(preds)} predictions for {n_images} images")
    for p in preds:
        s = np.asarray(p["subgraph_score"])
        ind = np.asarray(p["sorted_subgraph_ind"])
        if not 1 <= len(p["caption"]) <= keep or len(s) != len(p["caption"]):
            fail(f"image {p['image_id']}: {len(p['caption'])} captions")
        if not (np.isfinite(s).all() and (s > 0).all() and (s < 1).all()
                and (np.diff(s) <= 0).all()):
            fail(f"image {p['image_id']}: bad sGPN scores {s}")
        if len(set(ind.tolist())) != len(ind) or ind.min() < 0 \
                or ind.max() >= BUCKET:
            fail(f"image {p['image_id']}: bad keep set {ind}")
        if not all(isinstance(c, str) and c for c in p["caption"]):
            fail(f"image {p['image_id']}: empty caption")


def phase_times(params, state, examples, cfg, ecfg, device):
    """Median ms of encoder+sGPN+NMS and of the beam decode, one batch."""
    import torch
    from subgc_tpu_torch.decode.beam import beam_search
    from subgc_tpu_torch.eval.runner import _stack_examples
    from subgc_tpu_torch.graph import to_device
    from subgc_tpu_torch.models.subgc import encode_images_batched
    graph, subs = (to_device(x, device) for x in _stack_examples(examples))
    enc_ms, dec_ms = [], []
    with torch.no_grad():
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc = encode_images_batched(params, state, graph, subs, cfg, ecfg)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            beam_search(params, enc.feats, cfg, ecfg)
            torch.cuda.synchronize()
            enc_ms.append(1e3 * (t1 - t0))
            dec_ms.append(1e3 * (time.perf_counter() - t1))
    return statistics.median(enc_ms[1:]), statistics.median(dec_ms[1:])


def compare_card_cpu(gpu_preds, cpu_preds):
    """Keep sets must match; captions matched by sub-graph index."""
    n_same = n_total = 0
    for g, c in zip(gpu_preds, cpu_preds):
        gi = np.asarray(g["sorted_subgraph_ind"])
        ci = np.asarray(c["sorted_subgraph_ind"])
        if sorted(gi.tolist()) != sorted(ci.tolist()):
            fail(f"image {g['image_id']}: keep sets differ card {gi} cpu {ci}")
        gc = dict(zip(gi.tolist(), g["caption"]))
        cc = dict(zip(ci.tolist(), c["caption"]))
        gs = dict(zip(gi.tolist(), g["subgraph_score"]))
        cs = dict(zip(ci.tolist(), c["subgraph_score"]))
        for k in gc:
            n_total += 1
            n_same += gc[k] == cc[k]
            if abs(gs[k] - cs[k]) > 1e-4 * abs(cs[k]):
                fail(f"image {g['image_id']} sub-graph {k}: sGPN score card "
                     f"{gs[k]} cpu {cs[k]}")
    return n_same, n_total


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    if not os.path.isdir(os.path.join(HERE, "subgc_tpu_torch")):
        fail("run from the root of a checkout: subgc_tpu_torch/ is missing")
    sys.path.insert(0, HERE)
    from subgc_tpu_torch import (build_configs, params_from_numpy,
                                 run_test_split)
    from subgc_tpu_torch.models.params import init_params_numpy
    from subgc_tpu_torch.ops import _build
    from subgc_tpu_torch.ops import attention as A

    # ---- 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi unavailable"
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {name}, count {torch.cuda.device_count()}")

    # ---- 2. build
    _build.load("attention")
    info = _build.BUILD_INFO["attention"]
    if info["seconds"]:
        print(f"built attention.cu: nvcc {info['seconds']:.2f} s")
    else:
        print("attention.cu: library already built from this source")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ---- 3. kernel against plain on the card
    cfg, ecfg, _ = build_configs("Sub_GC_Kar",
                                 eval=dict(max_subgraph_bucket=BUCKET))
    params_np, state = init_params_numpy(cfg, seed=0)
    params = params_from_numpy(params_np, "cuda")
    keep = ecfg.gpn_max_subg
    S_main = BATCH_IMAGES * keep
    main_check = check_attention(params, "image", S_main, BATCH_IMAGES)
    checks = [main_check,
              check_attention(params, "subgraph", S_main, S_main, seed=1),
              check_attention(params, "image", 96 * keep, 96, seed=2),
              check_attention(params, "subgraph", 96 * keep, 96 * keep,
                              seed=3)]

    # ---- 4. main path at full width
    examples = make_examples(cfg, N_IMAGES, BUCKET)
    loader = MemoryLoader(examples)
    vocab = {str(i): f"w{i}" for i in range(1, cfg.vocab_size + 1)}
    run_test_split(params, state, loader, cfg, ecfg, vocab,
                   num_images=BATCH_IMAGES, verbose=False,
                   batch_images=BATCH_IMAGES, device="cuda")    # warm-up
    torch.cuda.synchronize()
    A.LAUNCHES = 0
    preds, wall, n_caps = run_test_split(
        params, state, loader, cfg, ecfg, vocab, verbose=False,
        batch_images=BATCH_IMAGES, device="cuda")
    launches = A.LAUNCHES
    n_dispatch = -(-N_IMAGES // BATCH_IMAGES)
    if launches != n_dispatch * cfg.seq_length:
        fail(f"attention kernel launched {launches} times on the main path, "
             f"expected {n_dispatch} dispatches x {cfg.seq_length} steps")
    check_predictions(preds, N_IMAGES, keep)
    enc_ms, dec_ms = phase_times(params, state, examples[:BATCH_IMAGES], cfg,
                                 ecfg, torch.device("cuda"))
    print(f"main path: {N_IMAGES} images, {n_caps} captions in {wall:.3f} s "
          f"= {n_caps / wall:.1f} captions/s; per {BATCH_IMAGES}-image "
          f"batch: encoder+sGPN+NMS {enc_ms:.2f} ms, beam decode "
          f"{dec_ms:.2f} ms; attention launches {launches}")

    # ---- 5. card against CPU on the first image batch
    cpu_params = params_from_numpy(params_np, "cpu")
    t0 = time.perf_counter()
    cpu_preds, _, _ = run_test_split(
        cpu_params, state, loader, cfg, ecfg, vocab, num_images=BATCH_IMAGES,
        verbose=False, batch_images=BATCH_IMAGES, device="cpu")
    n_same, n_total = compare_card_cpu(preds[:BATCH_IMAGES], cpu_preds)
    print(f"card vs cpu ({time.perf_counter() - t0:.1f} s on cpu): "
          f"{n_same}/{n_total} captions identical, keep sets identical")
    if n_same < 0.95 * n_total:
        fail(f"only {n_same}/{n_total} captions agree between card and cpu")

    kernels = [{
        "name": "shared_attention",
        "route": "cuda",
        "source": "subgc_tpu_torch/ops/csrc/attention.cu",
        "replaces": "subgc_tpu/ops/pallas_attention.py:75",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": main_check["ms"],
        "plain_ms": main_check["plain_ms"],
        "bound_ms": main_check["bound_ms"],
        "bound_by": main_check["bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
