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
   1e-4 (a float near-tie in a beam step may flip a word);
6. the per-row kernel (``row_attention``) against its plain version on the
   card at the grounding path's shape (R=160) and at R=960, and the
   beam-shared kernel at one beam in the greedy fan-out's layout (S=2000
   rows over 2 images); same tolerances;
7. Sub_GC_Flickr_GRD (greedy with attention capture, keep 10) on 64 images
   in 16-image batches with a ``GroundingCollector``: ``row_attention``
   must launch exactly dispatches x (seq_length + 1) times and the beam
   kernel never; against the CPU on the first batch: identical keep sets,
   >= 95% identical captions, and identical grounding entries for >= 95% of
   the images whose best caption is identical;
8. Sub_GC_MRNN (greedy over the image-shared fan-out, bucket 1024, NMS
   0.55, keep 1000) on 4 images in 2-image batches: the beam-shared kernel
   must launch exactly dispatches x seq_length times; against the CPU on
   one image: identical keep sets and >= 95% identical captions;
9. Sub_GC_S_MRNN (top-k sampling on the same fan-out): at the_k=1 the
   tokens equal phase 8's greedy tokens exactly; at the_k=3 every caption is
   non-empty and every recorded logprob is finite and <= 0.

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
FANOUT_IMAGES = 4        # the M-RNN fan-out: 2 dispatches of 2 images
FANOUT_BATCH = 2
FANOUT_BUCKET = 1024
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


def row_attention_bound_ms(R, Hin, N, H, D):
    """Least time for one ``row_attention`` launch, as attention_bound_ms
    counts it: every row reads its own streams."""
    nbytes = 4 * (R * Hin + R * N * (H + D) + R * N + Hin * H + 2 * H + 1
                  + R * (D + N))
    ops = R * (2 * Hin * H + 2 * N * H + 2 * N * D)
    t_bytes, t_ops = nbytes / HBM_RATE, ops / F32_PEAK
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def attention_inputs(params, layout, S, G, seed, beams=2):
    """Kernel inputs at full width: h in (-1, 1) like an LSTM output, the
    model's own h2att/alpha_net weights, projected node streams."""
    import torch
    dec = params["decoder"]
    dev = dec["h2att"]["w"].device
    n, R = 37, dec["h2att"]["w"].shape[0]
    H, D = dec["h2att"]["w"].shape[1], dec["att_embed"]["w"].shape[1]
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = G if layout == "image" else S
    h = torch.rand((S, beams, R), generator=g, device=dev) * 2 - 1
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


def compare_and_time(label, kernel, plain, x, bound):
    """A kernel against its plain version on the same card inputs (weights
    atol 1e-5, att_res rtol/atol 1e-4); times both."""
    out, w = kernel(*x)
    r_out, r_w = plain(*x)
    w_err = (w - r_w).abs().max().item()
    o_err = (out - r_out).abs()
    bad = (o_err > 1e-4 + 1e-4 * r_out.abs()).sum().item()
    if not (w_err <= 1e-5 and bad == 0):
        fail(f"{label} disagrees with its plain version: max |dw| "
             f"{w_err:.3g}, {bad} att_res entries out of rtol/atol 1e-4")
    res = {"max_abs_err": max(w_err, o_err.max().item()),
           "ms": cuda_ms(lambda: kernel(*x)),
           "plain_ms": cuda_ms(lambda: plain(*x)),
           "bound_ms": bound[0], "bound_by": bound[1]}
    print(f"{label}: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} "
          f"ms, bound {bound[0]:.4f} ms ({bound[1]}), max |err| "
          f"{res['max_abs_err']:.3g}")
    return res


def check_attention(params, layout, S, G, seed=0, beams=2):
    """The beam-shared kernel against its plain version on the card."""
    from subgc_tpu_torch.ops import attention as A
    x = attention_inputs(params, layout, S, G, seed, beams)
    _, B, R = x[0].shape
    G_, N, H = x[1].shape
    return compare_and_time(
        f"attention kernel {layout:8s} S={S:4d} G={G:4d} B={B}",
        A.shared_attention, A.shared_attention_ref, x,
        attention_bound_ms(S, B, R, G_, N, H, x[2].shape[-1]))


def check_row_attention(params, R, seed=0):
    """The per-row kernel against its plain version on the card at full
    width (left-packed sub-graph masks)."""
    import torch
    from subgc_tpu_torch.ops import attention as A
    dec = params["decoder"]
    dev = dec["h2att"]["w"].device
    Hin, H = dec["h2att"]["w"].shape
    n, D = 37, dec["att_embed"]["w"].shape[1]
    g = torch.Generator(device=dev).manual_seed(seed)
    count = torch.randint(3, 12, (R, 1), generator=g, device=dev)
    x = [torch.rand((R, Hin), generator=g, device=dev) * 2 - 1,
         torch.randn((R, n, H), generator=g, device=dev) * 0.5,
         torch.rand((R, n, D), generator=g, device=dev),
         (torch.arange(n, device=dev)[None] < count).float(),
         dec["h2att"]["w"], dec["h2att"]["b"], dec["alpha_net"]["w"],
         dec["alpha_net"]["b"]]
    return compare_and_time(f"row attention kernel R={R:4d}",
                            A.row_attention, A.row_attention_ref, x,
                            row_attention_bound_ms(R, Hin, n, H, D))


def make_examples(cfg, n_images, bucket, seed=0):
    """Synthetic test images in the shape of bench.py's ``make_image``, with
    detector boxes (drawn from their own stream) for the grounding path."""
    from subgc_tpu_torch.data.dataset import ImageInfo, TestExample
    from subgc_tpu_torch.graph import SceneGraph, SubgraphSet
    rng = np.random.RandomState(seed)
    box_rng = np.random.RandomState(seed + 1)
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
        boxes = box_rng.rand(N - 1, 4).astype("f") * 296
        boxes[:, 2:] += boxes[:, :2]
        out.append(TestExample(graph=graph, subs=subs, n_subgraphs=bucket,
                               info=ImageInfo(ix=i, id=i, file_path=""),
                               gts=np.zeros((0, cfg.seq_length), np.int64),
                               sg_raw={"boxes": boxes}))
    return out


class MemoryLoader:
    """``iter_split`` over in-memory examples (the runner's loader contract)."""

    def __init__(self, examples):
        self.examples = examples

    def iter_split(self, split="test", num_images=-1):
        n = len(self.examples) if num_images < 0 else num_images
        return iter(self.examples[:n])


def check_predictions(preds, n_images, keep, bucket=BUCKET):
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
                or ind.max() >= bucket:
            fail(f"image {p['image_id']}: bad keep set {ind}")
        if not all(isinstance(c, str) and c for c in p["caption"]):
            fail(f"image {p['image_id']}: empty caption")


def phase_times(params, state, examples, cfg, ecfg, device):
    """Median ms of encoder+sGPN+NMS and of the decode (beam search, or
    greedy / top-k at beam_size 1), one batch."""
    import torch
    from subgc_tpu_torch.decode.beam import beam_search
    from subgc_tpu_torch.decode.greedy import sample
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
            if ecfg.beam_size > 1:
                beam_search(params, enc.feats, cfg, ecfg)
            else:
                sample(params, enc.feats, cfg, ecfg)
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


def grounding_tables(vocab, examples):
    """word -> lemma -> detection class over the synthetic vocab (identity
    lemmas, every other word a class, as tests/test_grounding_e2e.py builds
    them for its first words), and 640 x 480 images."""
    words = [vocab[k] for k in sorted(vocab, key=int)]
    lemma_det = {w: i for i, w in enumerate(words[::2])}
    return ({w: w for w in words}, lemma_det,
            {i: w for w, i in lemma_det.items()},
            {ex.info.id: (640, 480) for ex in examples})


def run_grounding(params, cpu_params, state, examples, vocab):
    """Phase 7: Sub_GC_Flickr_GRD with a collector, card and CPU.  Returns
    the per-row kernel's launches."""
    import torch
    from subgc_tpu_torch import (GroundingCollector, build_configs,
                                 run_test_split)
    from subgc_tpu_torch.ops import attention as A
    cfg, ecfg, _ = build_configs("Sub_GC_Flickr_GRD",
                                 eval=dict(max_subgraph_bucket=BUCKET))
    loader = MemoryLoader(examples)
    tables = grounding_tables(vocab, examples)
    run_test_split(params, state, loader, cfg, ecfg, vocab,
                   num_images=BATCH_IMAGES, verbose=False,
                   batch_images=BATCH_IMAGES, device="cuda")    # warm-up
    torch.cuda.synchronize()
    col = GroundingCollector(*tables)
    A.LAUNCHES = A.ROW_LAUNCHES = 0
    preds, wall, n_caps = run_test_split(
        params, state, loader, cfg, ecfg, vocab, verbose=False,
        batch_images=BATCH_IMAGES, device="cuda", collect_grounding=col)
    launches, beam_launches = A.ROW_LAUNCHES, A.LAUNCHES
    n_dispatch = -(-len(examples) // BATCH_IMAGES)
    if launches != n_dispatch * (cfg.seq_length + 1) or beam_launches:
        fail(f"grounding path: row kernel launched {launches} times, beam "
             f"kernel {beam_launches}; expected {n_dispatch} dispatches x "
             f"{cfg.seq_length + 1} steps and 0")
    check_predictions(preds, len(examples), ecfg.gpn_max_subg)
    if sorted(col.output) != sorted(str(ex.info.id) for ex in examples):
        fail("grounding path: the collector missed images")
    n_boxes = sum(len(e[0]["bbox"]) for e in col.output.values())
    print(f"grounding path (Sub_GC_Flickr_GRD): {len(examples)} images, "
          f"{n_caps} captions in {wall:.3f} s = {n_caps / wall:.1f} "
          f"captions/s; {n_boxes} grounded words; row kernel launches "
          f"{launches}")

    cpu_col = GroundingCollector(*tables)
    t0 = time.perf_counter()
    cpu_preds, _, _ = run_test_split(
        cpu_params, state, loader, cfg, ecfg, vocab, num_images=BATCH_IMAGES,
        verbose=False, batch_images=BATCH_IMAGES, device="cpu",
        collect_grounding=cpu_col)
    n_same, n_total = compare_card_cpu(preds[:BATCH_IMAGES], cpu_preds)
    same_best = [str(g["image_id"]) for g, c in zip(preds, cpu_preds)
                 if g["caption"][0] == c["caption"][0]]
    n_grd = sum(col.output[i] == cpu_col.output[i] for i in same_best)
    print(f"grounding card vs cpu ({time.perf_counter() - t0:.1f} s on "
          f"cpu): {n_same}/{n_total} captions identical, keep sets "
          f"identical, grounding entries identical for {n_grd}/"
          f"{len(same_best)} images with the same best caption")
    if n_same < 0.95 * n_total:
        fail(f"grounding: only {n_same}/{n_total} captions agree between "
             f"card and cpu")
    if n_grd < 0.95 * len(same_best):
        fail(f"grounding: entries agree for only {n_grd}/{len(same_best)} "
             f"images")
    return launches


def run_fanout(params, cpu_params, state, vocab):
    """Phase 8: Sub_GC_MRNN (greedy, keep 1000 at bucket 1024), card and
    CPU.  Returns (beam-shared kernel launches, predictions with tokens,
    the examples)."""
    import torch
    from subgc_tpu_torch import build_configs, run_test_split
    from subgc_tpu_torch.ops import attention as A
    cfg, ecfg, _ = build_configs("Sub_GC_MRNN",
                                 eval=dict(max_subgraph_bucket=FANOUT_BUCKET))
    examples = make_examples(cfg, FANOUT_IMAGES, FANOUT_BUCKET, seed=1)
    loader = MemoryLoader(examples)
    run_test_split(params, state, loader, cfg, ecfg, vocab,
                   num_images=FANOUT_BATCH, verbose=False,
                   batch_images=FANOUT_BATCH, device="cuda")    # warm-up
    torch.cuda.synchronize()
    A.LAUNCHES = A.ROW_LAUNCHES = 0
    preds, wall, n_caps = run_test_split(
        params, state, loader, cfg, ecfg, vocab, verbose=False,
        batch_images=FANOUT_BATCH, keep_tokens=True, device="cuda")
    launches, row_launches = A.LAUNCHES, A.ROW_LAUNCHES
    n_dispatch = -(-FANOUT_IMAGES // FANOUT_BATCH)
    if launches != n_dispatch * cfg.seq_length or row_launches:
        fail(f"fan-out path: beam-shared kernel launched {launches} times, "
             f"row kernel {row_launches}; expected {n_dispatch} dispatches "
             f"x {cfg.seq_length} steps and 0")
    check_predictions(preds, FANOUT_IMAGES, ecfg.gpn_max_subg, FANOUT_BUCKET)
    enc_ms, dec_ms = phase_times(params, state, examples[:FANOUT_BATCH], cfg,
                                 ecfg, torch.device("cuda"))
    print(f"fan-out path (Sub_GC_MRNN): {FANOUT_IMAGES} images, {n_caps} "
          f"captions in {wall:.3f} s = {n_caps / wall:.1f} captions/s; per "
          f"{FANOUT_BATCH}-image batch: encoder+sGPN+NMS {enc_ms:.2f} ms, "
          f"greedy decode {dec_ms:.2f} ms; beam-shared kernel launches "
          f"{launches}")

    t0 = time.perf_counter()
    cpu_preds, _, _ = run_test_split(
        cpu_params, state, loader, cfg, ecfg, vocab, num_images=1,
        verbose=False, batch_images=1, device="cpu")
    n_same, n_total = compare_card_cpu(preds[:1], cpu_preds)
    print(f"fan-out card vs cpu ({time.perf_counter() - t0:.1f} s on cpu, "
          f"one image): {n_same}/{n_total} captions identical, keep sets "
          f"identical")
    if n_same < 0.95 * n_total:
        fail(f"fan-out: only {n_same}/{n_total} captions agree between card "
             f"and cpu")
    return launches, preds, examples


def run_topk(params, state, vocab, examples, greedy_preds):
    """Phase 9: Sub_GC_S_MRNN on phase 8's images."""
    import torch
    from subgc_tpu_torch import build_configs, run_test_split
    from subgc_tpu_torch.eval.runner import (_stack_examples,
                                             make_batched_infer_fn)
    from subgc_tpu_torch.graph import to_device
    cfg, ecfg, _ = build_configs("Sub_GC_S_MRNN",
                                 eval=dict(max_subgraph_bucket=FANOUT_BUCKET))
    loader = MemoryLoader(examples)
    top1, _, _ = run_test_split(
        params, state, loader, cfg, ecfg.replace(the_k=1), vocab,
        verbose=False, batch_images=FANOUT_BATCH, keep_tokens=True,
        device="cuda")
    for a, b in zip(top1, greedy_preds):
        if not (np.array_equal(a["sorted_subgraph_ind"],
                               b["sorted_subgraph_ind"])
                and np.array_equal(a["tokens"], b["tokens"])):
            fail(f"top-k at the_k=1: image {a['image_id']} differs from the "
                 f"greedy decode")
    preds, wall, n_caps = run_test_split(
        params, state, loader, cfg, ecfg, vocab, verbose=False,
        batch_images=FANOUT_BATCH, device="cuda")
    check_predictions(preds, len(examples), ecfg.gpn_max_subg, FANOUT_BUCKET)
    dev = torch.device("cuda")
    graph, subs = _stack_examples(examples[:FANOUT_BATCH])
    out = make_batched_infer_fn(cfg, ecfg)(
        params, state, to_device(graph, dev), to_device(subs, dev),
        torch.Generator(device=dev).manual_seed(2019))
    lp = out["logprobs"][out["keep_valid"]]
    if not (torch.isfinite(lp).all() and (lp <= 0).all()):
        fail("top-k at the_k=3: a recorded logprob is not finite and <= 0")
    print(f"top-k fan-out (Sub_GC_S_MRNN): the_k=1 tokens equal the greedy "
          f"tokens; the_k={ecfg.the_k}: {n_caps} captions in {wall:.3f} s = "
          f"{n_caps / wall:.1f} captions/s, none empty; {lp.numel()} "
          f"recorded logprobs finite and <= 0")


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
    _build.load("attention")        # both kernels: one source
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

    # ---- 6. the per-row kernel; the beam-shared kernel at one beam
    row_checks = [check_row_attention(params, S_main, seed=5),
                  check_row_attention(params, 96 * keep, seed=6)]
    checks.append(check_attention(params, "image", 2000, 2, seed=4, beams=1))

    # ---- 7-9. grounding, fan-out and top-k paths
    grd_launches = run_grounding(params, cpu_params, state, examples, vocab)
    fan_launches, greedy_preds, fan_examples = run_fanout(
        params, cpu_params, state, vocab)
    run_topk(params, state, vocab, fan_examples, greedy_preds)

    kernels = [{
        "name": "shared_attention",
        "route": "cuda",
        "source": "subgc_tpu_torch/ops/csrc/attention.cu",
        "replaces": "subgc_tpu/ops/pallas_attention.py:75",
        "launches": launches + fan_launches,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": main_check["ms"],
        "plain_ms": main_check["plain_ms"],
        "bound_ms": main_check["bound_ms"],
        "bound_by": main_check["bound_by"],
        "library_ms": None,
    }, {
        "name": "row_attention",
        "route": "cuda",
        "source": "subgc_tpu_torch/ops/csrc/attention.cu",
        "replaces": "subgc_tpu/ops/pallas_attention.py:29",
        "launches": grd_launches,
        "max_abs_err": max(c["max_abs_err"] for c in row_checks),
        "ms": row_checks[0]["ms"],
        "plain_ms": row_checks[0]["plain_ms"],
        "bound_ms": row_checks[0]["bound_ms"],
        "bound_by": row_checks[0]["bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
