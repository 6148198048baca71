#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (subgc_tpu_torch) on one NVIDIA card, check it
and time it.  Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. device: the card's name and power limit (nvidia-smi); TF32 off, since the
   reference is full float32, and bf16 matmuls summing in float32
   (``allow_bf16_reduced_precision_reduction`` off), as the JAX package's;
2. build: every kernel of the main path from ``subgc_tpu_torch/ops/csrc``;
3. kernel against its plain version on the card, float32, both beam layouts,
   at the main path's shape and at a 96-image batch (S=960 rows);
   tolerances: weights atol 1e-5, att_res rtol 1e-4 / atol 1e-4 (float32
   summation order);
4. the Sub_GC_Kar main path at full model width (``ModelConfig()`` defaults,
   beam 2, NMS 0.75, keep 10, bucket 128) with random weights from a seed, on
   synthetic images shaped like ``bench.py``'s, through ``run_test_split``;
   every kernel must have launched exactly dispatches x seq_length times
   (the projection kernel once per attention launch, here and on every
   path below);
5. the card against the CPU (plain attention) on the first image batch:
   identical keep sets, >= 95% identical captions, sGPN scores within rtol
   1e-4 (a float near-tie in a beam step may flip a word);
6. the per-row kernel (``row_attention``) against its plain version on the
   card at the grounding path's shape (R=160) and at R=960, and the
   beam-shared kernel at one beam in the greedy fan-out's layout (S=2000
   rows over 2 images); same tolerances; the projection stage alone
   (``attention_project``) against its plain version at Q=320, 2000 and 160
   (rtol / atol 1e-5), timed beside ``torch.addmm`` as a yardstick
   (printed as a ``{"projection_stage": [...]}`` line);
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
   ``decode_sequence`` of its tokens, no token lies outside the vocabulary,
   nothing follows a caption's first EOS (what holds for trained weights
   too, which may end a caption at once), and every recorded logprob is
   finite and <= 0;
10. the beam-shared kernel at 3 beams in the per-sub-graph layout (S=1 and
    S=32 rows), Full_GC_Kar's shape, against its plain version (same
    tolerances);
11. Full_GC_Kar (GCN with BatchNorm, 4 layers, residual 1, no sGPN, beam 3)
    on 32 images through ``encode_image`` + ``beam_search``, one image at a
    time, with BatchNorm running statistics drawn from the seed: the
    beam-shared kernel must launch exactly 32 x seq_length times (S=1 row
    of 3 beams each) and the per-row kernel never; against the CPU on every
    image: >= 95% identical captions;
12. Sub_GC_Flickr_CTL (controllability: one sub-graph per region set,
    built greedily by ``data/sct.py``, no NMS, region-set order) on 64
    images with 2-5 region sets each, bucket 32, in 16-image batches:
    launches exactly dispatches x seq_length, every image's
    ``sorted_subgraph_ind`` equal to ``arange(region sets)``; against the
    CPU on the first batch: identical sub-graph sets and >= 95% identical
    captions;
13. Sub_GC_Sup_Flickr_CTL (GT sub-graphs looked up by seed nodes, the
    Sup. model without an sGPN scorer) on the same kind of images: every
    score exactly 1, and phase 12's checks; then the beam-shared kernel
    alone at the CTL presets' shape (image-shared, S=512, G=16, 2 beams)
    against its plain version;
13a. language eval (``align_predictions`` + ``language_eval`` at oracle 5:
    BLEU 1-4, METEOR, ROUGE-L, CIDEr-D, SPICE) of phase 4's card captions
    against 5 GT captions per image drawn from the vocabulary with a seed:
    every score matrix finite and in range (CIDEr-D in [0, 10], the others
    in [0, 1]); phase 5's CPU captions and the card's first batch scored
    alike, with identical per-image scores for every image whose 5 ranked
    captions are identical on both (>= 75% of the batch); host seconds per
    image;
13b. diversity (``diversity_report`` with mBLEU-4) of phase 8's card
    captions: distinct, n-gram and mBLEU-4 finite and in [0, 1];
13c. controllability (``controllability_scores``) of phase 12's card
    captions against seeded GT groups and seeded noun vectors: NounIoU and
    every metric finite;
13d. the rerank NN search (``find_nn_images``) on the card at Karpathy COCO
    size: 5,000 test against 113,287 train images, 2048-d float32 features
    made on the card from a seed, top 1000; median ms against the bound of
    its matmul; then 256 test rows against 20,000 train rows of integer
    features in [-4, 4] (exact float32 distances) with duplicated rows and
    a tie group across rank 1000: indices equal to a float64 numpy
    argsort with index tie-break, rank for rank; then ``consensus_rerank``
    (k 60, m 125) of 8 images of phase 4's captions over that search's
    neighbours, with host seconds (printed as an ``{"eval": ...}`` line);
14. both kernels alone at the val passes' shapes against their plain
    versions (same tolerances): per-row at R=320, beam-shared image-shared
    at S=320, G=64, one beam; then
    Sub_GC_Kar training at full width (``TrainConfig()``: 64 images = 320
    sentences, 17 steps, float32) on the port's ``synthetic_train_batch``:
    3 steps of the hoisted train step, then 2 with scheduled sampling at
    ss_prob 0.25, dropout on (a seeded generator), the step counter past
    the LR warmup; after every step the loss and gradient norm are finite
    and every decoder parameter moved; one more step of each kind runs
    under CUDA's sync debug mode set to raise and must make no host sync;
    ms per step, images/s, peak memory.
    Then one ``backward`` on 2 images (10 sentences) with dropout off, card
    against CPU from identical params: loss within rtol 1e-5, every
    parameter's gradient within 1e-3 of the CPU's relative to its norm
    (plus 1e-6 of the whole gradient's norm, the floor for ``alpha_net``'s
    bias, whose true gradient is 0), and non-zero on the card wherever it
    is non-zero on the CPU (``decoder.h2att``, ``alpha_net``, ``ctx2att``
    and ``att_embed`` named); then the val pass (``make_val_step``, no
    autograd) on the 64 images: ``row_attention`` launches exactly 17
    times (once per step), the beam-shared kernel never, and its loss
    equals the CPU's (plain attention, the same trained params) within rtol
    1e-5, as it does on 2 images from the initial params;
15. the same model under ``share_att_train``: card-vs-CPU gradients on 2
    images as in 14, and a val pass of 64 images through which the
    beam-shared kernel launches exactly 17 times at one beam, its loss
    against the CPU's as in 14;
16. Full_GC_Kar training at full width (the preset's model: GCN BatchNorm,
    4 layers, residual 1; 100 images = 500 sentences): 2 steps, after
    which the GCN running statistics have moved and are finite; card
    against CPU on 2 images: the new BatchNorm state within atol 1e-5 and
    the gradients as in 14; one more step without a host sync.  Each
    training phase reads its own peak memory: the earlier phases' tensors
    have left the card by then.

The bfloat16 chain (``compute_dtype="bfloat16"``); 17-19 run after 13d,
while the test params are on the card, and 20 after 16:

17. both bf16 kernel variants against their plain versions on the card:
    the beam-shared one at Sub_GC_Kar's shapes (image-shared S=160, G=16,
    and per-sub-graph S=160, 2 beams), the M-RNN fan-out (S=2000, G=2, one
    beam) and Full_GC_Kar's (S=1, 3 beams), weights atol 2e-3 and att_res,
    rounded to bf16, rtol 1e-2; the per-row one at the grounding path's
    R=160 and the val pass's R=320, float32 tolerances (its math is
    float32); ms, plain ms, the bound with bf16 bytes and the bf16
    tensor-core peak, and the same bytes with the float32 peak; each
    entry's two stages (the tensor-core projection, the attention kernel)
    timed apart with CUDA events (the projection alone at the entry's
    plan, the entry less it) and, where the card's trace holds them, from
    a ``torch.profiler`` trace; the bf16 projection alone
    at Q=320, 2000, 160 and 3 against its plain version (rtol / atol 1e-5)
    beside ``torch.addmm`` in bf16 (printed as a
    ``{"projection_stage_bf16": [...]}`` line with the card's name and
    power limit);
18. Sub_GC_Kar in bf16 + bf16 gates (bench.py's decode configuration) on
    phase 4's 64 images: the shared bf16 kernel exactly dispatches x
    seq_length times and no other; captions checked as in 4, captions/s;
    card against CPU (bf16) on the first batch: sGPN scores within atol
    2e-2, keep sets identical on >= 90% of the images, one full-width
    ``decode_step`` from the same features, state and tokens within atol
    5e-2; caption agreement against the CPU's bf16 and the card's float32
    captions printed, not gated (a near-tie flips a word);
19. Sub_GC_Flickr_GRD in bf16 + bf16 gates with a collector: the row bf16
    kernel exactly dispatches x (seq_length + 1) times and no other; card
    against CPU on the first batch printed;
20. Sub_GC_Kar training in bf16 + bf16 gates + bf16 residuals (bench.py's
    train step) at 64 images: 3 hoisted steps checked as in 14 (ms,
    images/s, peak memory), one more without a host sync; card against
    CPU on 2 images: loss within rtol 1e-3, no live gradient lost, each
    that holds >= 1e-3 of the whole gradient's norm with cosine >= 0.99,
    the smaller (the attention's score leaves, whose sums cancel) within
    1e-4 of the whole norm; the val pass: the row bf16 kernel exactly 17
    times, its loss against the CPU's within rtol 1e-3 and against the
    card's float32 val pass within rtol 1e-2.

Serving and SCST; 21 runs after 19, 22 after 20:

21. the beam kernel alone at a serving dispatch's shapes (8 images x keep
    10 = 80 rows of 2 beams: per-sub-graph float32, image-shared bf16);
    then Sub_GC_Kar served over real HTTP on 127.0.0.1: the port's
    ``save_checkpoint`` writes the weights, ``cli/serve.py::load_registry``
    loads them (beam 2, NMS 0.75, keep 10, bucket 128, 8 images a
    dispatch, queue cap 256, default dtype bfloat16), ``warmup`` runs and
    ``serve`` answers from a thread.  Per dtype (float32: per-sub-graph
    ``shared_attention``; bf16: image-shared ``subgc_shared_attention_
    bf16``), on phase 4's first 32 images as requests: (a) 8 single
    requests, each answer (captions and scores) exactly that of
    ``make_batched_infer_fn`` on the image alone at the same padding;
    (b) 32 concurrent clients, one image each: fewer dispatches than
    requests, every answer exactly its answer alone, the dtype's kernel
    exactly dispatches x seq_length launches and no other kernel;
    (d) a request without sub-graphs, through the sampled bank, exactly
    the direct answer; (e) a ``/caption_stream`` of 16 images in chunks
    of 4: 16 result lines then ``{"done": true, "count": 16}``; images/s
    and p50 / p90 latency at 1, 8 and 32 clients (client clock and
    ``/stats``), dispatches and mean fill, host ms per image of
    ``json.loads`` and ``to_example``.  (c) the float32 server's first 8
    answers against ``build_service`` on the CPU: identical keep sets, >=
    95% identical captions, scores within rtol 1e-4.  (f) a 12-request
    burst against a service with queue cap 2 at one image a dispatch:
    only 200 and 429, both, each 429 with ``Retry-After``, the shed count
    equal to the 429s;
22. SCST on Sub_GC_Kar at 64 images x 5 sentences: greedy tokens card
    against CPU on 16 images (>= 95% identical in float32), the sample's
    logprobs (``row_attention``, no autograd) against the update's
    recomputation (``attention_teacher``) within atol 1e-4 up to each
    EOS, the update's loss and gradients card against CPU on 2 images at
    the card's sample and seeded rewards (random weights earn CIDEr 0,
    hence zero gradients; phase 14's rule, phase 20's in bf16);
    then 3 float32 steps and 1 bf16 + bf16 gates step, each with the row
    kernel of its dtype exactly 2 x seq_length launches and no other, no
    token after an EOS, a finite loss, timed as sample, host reward and
    update; then one step of ``adamw``, ``sgd``, ``rmsprop`` and
    ``adagrad`` at full width on the card against the CPU on the same
    clipped gradients: params within rtol 1e-5 of the larger of each
    param before and after the step.

Diverse beam groups and the host side; 23 runs after 19, 24 after 22:

23. Sub_GC_Kar in diverse beam groups (beam 4 in 2 groups of 2, diversity
    lambda 0.5) on phase 4's first 16 images, float32 and bf16 + bf16
    gates: the dtype's beam-shared kernel exactly groups x seq_length
    launches (one per active group and step, at B = 2) and no other;
    card against CPU: identical keep sets, float32 >= 95% identical
    captions and scores within rtol 1e-4, bf16 scores within 2e-2 and the
    caption agreement printed (phase 18's rule); then the kernel alone at
    the groups' shape (image-shared, S=160, G=16, B=2), both dtypes;
24. the host library built with g++ from ``native/`` (build seconds); the
    C++ tokenizer, mBLEU-4 and pairwise CIDEr against their Python paths
    on phase 4's captions (rtol 1e-10), host ms per image of both; a
    64-image packed shard written by the port at full width (1,000
    sub-graphs a record, in the temporary directory), read
    equal, field for field, by the C++ and the numpy readers and equal to
    what was packed, gather ms per image against the npz read; the C++
    and Python samplers' ms per image on its 5 x 1005 node-IoU matrices;
    three Sub_GC_Kar float32 train steps (64 images) from batches a
    ``BatchPrefetcher`` copies from pinned memory on its own stream,
    bitwise equal (losses and params) to the same batches copied
    synchronously, under PyTorch's deterministic algorithms; ms of the
    data and step phases of both.

Parallelism; 25 runs after 23, 26 after 24.  The mesh is every card when
there are two or more, else ``[cuda:0, cuda:0]`` (the shards take turns
on the one card):

25. sharded decode, each against its unsharded run (identical keep sets,
    sGPN scores rtol 1e-5, >= 95% identical captions with the count
    printed, the beam-shared kernel exactly dispatches x shards x
    seq_length times, the projection with each; wall per batch of both,
    over several dispatches with the model already on every mesh device,
    and the copy's ms on its own): (a) Sub_GC_Kar on phase 4's 64 images,
    16 a dispatch, over the image axis; (b) Sub_GC_MRNN keep 1000 on phase
    8's 4 images, one a dispatch, over the sub-graph axis, 2 chunks of 500
    rows; (c) ``ModelService(mesh=...)`` in float32 on phase 21's 32 burst
    images, 8 a dispatch, with the services' set-up ms; (d) with two cards
    or more, both kernels and the projection
    on ``cuda:1`` launched from a thread whose current device is
    ``cuda:0``, against their plain versions; and the kernel alone at the
    shards' shapes (image-shared S=80, G=8, B=2 on one card; S=500, G=1,
    B=1);
26. data-parallel training in spawned ranks (``parallel/steps.py``) at
    full width, Sub_GC_Kar at 64 images and Full_GC_Kar at 100 (its GCN
    BatchNorm synced), two hoisted steps each from iteration 0 with
    dropout on and a val pass, against the same run in one process on
    cuda:0 (TF32 off): two gloo ranks on cuda:0 (NCCL refuses two ranks on
    one card), a one-rank NCCL group (Sub_GC_Kar), and with two cards or
    more NCCL over 2 or 4 of them.  Every metric rtol 1e-5; the gradients
    the optimizer gets in the first step with a learning rate above 0
    (``parallel/steps.py::same_gradients``): the whole gradient within
    ``DP_WHOLE_ULPS`` times the distance (L2, relative) of a one-process
    run from weights one ulp away, and at least 2e-4, each leaf rtol
    ``DP_LEAF_RTOL`` of its own, the leaves whose gradient is zero in
    exact arithmetic float noise in both runs;
    running statistics rtol 2e-4 / atol 1e-6; the same parameter bits on
    every rank, each rank's global val loss
    rtol 1e-5 with exactly seq_length + 1 row-kernel launches; ms per step
    per rank, the gradient bucket's all-reduce ms and process start-up
    seconds printed.

The published-weights route; 27 runs last:

27. (a) a seeded Sub_GC_Kar state_dict in the reference's layout (its key
    names, torch's ``[out, in]`` Linear and ``[4H, in]`` LSTMCell weights,
    BatchNorm ``num_batches_tracked``) at ``ModelConfig()`` widths,
    ``torch.save``d as ``model-60000.pth`` beside an ``infos_*.pkl``
    (``argparse.Namespace`` opt, vocab, iter, epoch); ``cli/convert_ckpt.py
    --pth --infos --out DIR`` (seconds, MiB); ``setup(start_from=DIR,
    device="cuda")`` equal to the seeded arrays bitwise; the beam-shared
    kernel against its plain version at the phase's shape (image-shared,
    S=160, G=16, B=2) on the converted weights; then ``cli/test.py`` on 16
    synthetic images at the model's widths (npz label file) with
    ``--device cuda``: the kernel exactly seq_length launches (one
    dispatch), captions/s; and with ``--device cpu``: identical keep sets,
    >= 95% identical captions, sGPN scores rtol 1e-4; (b) the same route
    for Full_GC_Kar (GCN BatchNorm keys, ``--full-gc``'s layout) on one
    image through ``encode_image`` + ``beam_search`` (S=1, 3 beams):
    seq_length launches, the kernel at that shape, the card's caption the
    CPU's; (c) ``cli/quickstart.py --device cuda`` in a temporary workdir
    runs to its end (train, decode + language eval, diversity, rerank).

Phase 28 runs between phases 3 and 4: the split-TF32 GEMM
(``ops/gemm.py``) at ``decode_step``'s seven products, at the rows of
``sub_gc.mrnn_test`` (16 images x ~304 kept sub-graphs = 4,864) and
``sub_gc.kar_test`` (320): each weight prepared as a decode call prepares
it (its TF32 halves, transposed; ms and bytes), then each product on the
prepared weight (the decode's path) and on the raw weight (same bits):
its largest error against float64 at most 4x torch's float32 product's;
ms, TFLOP/s, the bound (2 M N K at the 495 TFLOP/s TF32 peak, or the
compulsory bytes, and beside it the three passes' 3 x 2 M N K and its
share), the plain version's and torch.matmul's ms; then the sweep of a
step's seven products over rows, kernel against torch.matmul with the
host's time a call, behind ``decoder.SPLIT_GEMM_MIN_ROWS``.  Every checked
decode path above resets the GEMM's counters beside the attention
counters and checks them: 7 launches a step (6 in the teacher-forced val
pass) and as many weight preparations a decode call where a float32
decode without gradient has ``SPLIT_GEMM_MIN_ROWS`` rows or more (the
fan-out path's M-RNN decode, which must take it), none below, in bf16 or
in training.  A test decode's rows are its dispatch's kept sub-graphs
(under SCT its real region sets) times the beams, not its keep slots:
only those decode.

Phase 29 runs after phase 5: the Sub_GC_Kar beam decode of one 16-image
dispatch (phase 4's first images, all 160 rows, beam 2) eagerly (the
graph cache cleared before each call) and from the captured CUDA graphs
(``decode/graphs.py``: the key's first call eager, its second captures,
then replays): the capture's and the replays' outputs equal the eager
search's bit for bit (``seq``, ``logprobs``, ``all_seqs``, ``all_ps``),
one chain kept, and the replays' attention launches exactly seq_length a
search (the projection with each, no split-TF32 GEMM at 320 rows); the
median synchronised wall and the host's enqueue time of both ways, and
the capture call's ms and device memory.

Phase 30 runs after phase 28: the sGPN test path's kernels
(``ops/sgpn.py``) on one test dispatch's shapes, 16 images x 1,024
sub-graph slots (each image's bank of 1,000 sampled sub-graphs over 36
detections and 64 relations, ``data/subgraph_sampler.py``) x 37 nodes, L
= 1,024: the read-out max bit for bit the torch path's masked broadcast,
its ms beside the broadcast's (``models/gpn.py::masked_max``) and its
bound (the compulsory bytes at HBM rate), and the device memory the
broadcast needs; then at each test cell's threshold and keep (``kar_test`` 0.75 and
10, ``mrnn_test`` 0.55 and 1,000) the NMS kernel's keep sets equal to the
torch fixpoint's, the kernel's ms beside its bound, ``subgraph_nms``'s ms
on both routes (the torch route's host-synced rounds counted), and the
sGPN's test forward and NMS together on both routes, at the model's
widths, their read-outs and scores equal bit for bit.  Phase 4 checks one
launch of each kernel a dispatch.

Prints a ``{"kernels": [...]}`` line (both attention kernels, their bf16
variants, the split-TF32 GEMM and the two sGPN kernels), then ``{"ok":
true, "device": ...}`` as the last line.  Needs
no network and imports no jax.
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
FULLGC_IMAGES = 32       # Full_GC_Kar, decoded one image at a time
SCT_IMAGES = 64          # the CTL presets: 4 dispatches of 16 images
SCT_BUCKET = 32          # SCTLoader's default bucket
TRAIN_CHECK_IMAGES = 2   # card-vs-CPU gradients at full width
F32_PEAK = 67e12         # H100 SXM float32 outside the tensor cores, FLOP/s
BF16_PEAK = 989e12       # H100 SXM bf16 on the tensor cores, dense, FLOP/s
HBM_RATE = 3.35e12       # H100 SXM device memory, bytes/s
TF32_PEAK = 495e12       # H100 SXM TF32 on the tensor cores, dense, FLOP/s
# decode_step's rows in the two test cells: sub_gc.mrnn_test decodes the
# kept sub-graphs of keep 1000 for 16 images (~4,860, 4,750-4,890 a
# dispatch), sub_gc.kar_test keep 10 x 16 images x 2 beams
SPLIT_GEMM_ROWS = {"sub_gc.mrnn_test": 16 * 304, "sub_gc.kar_test": 320}
# phase 26: the ranks' gradient against the one-process step's.  At full
# width a few ReLU inputs lie within the two runs' rounding difference of
# 0 and take the other side in one of them; one such input moves the
# leaves on its path by up to ~5e-3 of their norm (Sub_GC_Kar: one unit
# of fc_embed1, one column of its weight's gradient).  Weights one ulp
# away (``parallel/steps.py::one_ulp_away``) flip such inputs too: that
# control's distance is the model's own float sensitivity.  So the whole
# gradient is held to DP_WHOLE_ULPS times the control's distance, and at
# least 2e-4; each leaf to DP_LEAF_RTOL: a leaf wrong by 1% or more fails.
DP_WHOLE_ULPS = 4
DP_LEAF_RTOL = 1e-2
# the shared bf16 kernel against its plain version, as the CPU tests hold
# the plain version to the Pallas kernel: weights atol 2e-3, att_res
# rounded to bf16 (as its consumer rounds it) rtol 1e-2
BF16_SHARED_TOL = dict(w_atol=2e-3, out_rtol=1e-2, out_atol=1e-6,
                       round_out=True)


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


def _bound(nbytes, ops, peak):
    t_bytes, t_ops = nbytes / HBM_RATE, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def attention_bound_ms(S, B, R, G, N, H, D, bf16=False, peak=None):
    """Least time for one launch: compulsory bytes over HBM rate against
    operations over the peak for their type (a multiply-add counts 2):
    float32 on the CUDA cores, or with ``bf16`` (streams h, p_att, att,
    wh, v of 2 bytes; bh, bv, mask and the float32 outputs of 4) the bf16
    tensor-core peak; ``peak`` overrides it.  Returns (ms, "bytes" or
    "operations")."""
    s = 2 if bf16 else 4
    nbytes = (s * (S * B * R + G * N * (H + D) + R * H + H)
              + 4 * (S * N + S + H + 1 + S * B * (D + N)))
    ops = S * B * (2 * R * H + 2 * N * H + 2 * N * D)
    return _bound(nbytes, ops, peak or (BF16_PEAK if bf16 else F32_PEAK))


def row_attention_bound_ms(R, Hin, N, H, D, bf16=False, peak=None):
    """Least time for one ``row_attention`` launch, as attention_bound_ms
    counts it: every row reads its own streams."""
    s = 2 if bf16 else 4
    nbytes = (s * (R * Hin + R * N * (H + D) + Hin * H + H)
              + 4 * (R * N + H + 1 + R * (D + N)))
    ops = R * (2 * Hin * H + 2 * N * H + 2 * N * D)
    return _bound(nbytes, ops, peak or (BF16_PEAK if bf16 else F32_PEAK))


def project_bound_ms(Q, Hin, H, bf16=False):
    """Least time for the projection stage alone (h @ wh + bh), counted as
    attention_bound_ms counts it (``bf16``: h and wh of 2 bytes, the bf16
    tensor-core peak)."""
    s = 2 if bf16 else 4
    nbytes = s * (Q * Hin + Hin * H) + 4 * (H + Q * H)
    return _bound(nbytes, 2 * Q * Hin * H, BF16_PEAK if bf16 else F32_PEAK)


def stage_ms(whole_ms, project, fn, runs=20):
    """Each bf16 entry's two stages, read two ways.  CUDA events
    (``cuda_ms``): the projection alone at the entry's plan (``project()``,
    the tensor-core kernel and its split-sum kernel, whose sum the entry
    leaves to its attention kernel) as "project_ms", and the entry's
    ``whole_ms`` less that as "attend_ms".  ``torch.profiler``: the median
    device span of each kernel ``fn()`` launches over ``runs`` calls, as
    "project_prof_ms" and "attend_prof_ms"; in the bf16 entries the
    attention kernel starts while the projection runs (a programmatic
    dependent launch), so its span includes its wait.  A card whose tracing
    delivers no kernel (CUPTI in a sandbox may not) leaves the profiler's
    two None: they are a reading beside the events, not a check."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    project_ms = cuda_ms(project)
    res = {"project_ms": project_ms, "attend_ms": whole_ms - project_ms,
           "project_prof_ms": None, "attend_prof_ms": None}
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    spans = {"project": [], "attend": []}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for stage in spans:
            if stage in e.name:
                spans[stage].append(e.time_range.elapsed_us() / 1e3)
    if all(spans.values()):
        res.update({f"{k}_prof_ms": statistics.median(v)
                    for k, v in spans.items()})
    return res


def check_projection(params, Q, seed=0, bf16=False):
    """The projection stage (``attention_project``) against its plain
    version on the card (rtol / atol 1e-5), timed beside one library call,
    ``torch.addmm(bh, h, wh)`` (with ``bf16`` h and wh in bfloat16, the
    tensor-core kernel, and ``torch.addmm`` in bf16), which the port never
    calls."""
    import torch
    from subgc_tpu_torch.ops import attention as A
    dec = params["decoder"]
    wh, bh = dec["h2att"]["w"], dec["h2att"]["b"]
    g = torch.Generator(device=wh.device).manual_seed(seed)
    h = torch.rand((Q, wh.shape[0]), generator=g, device=wh.device) * 2 - 1
    lib_bh = bh
    if bf16:
        h, wh, lib_bh = h.to(torch.bfloat16), wh.to(torch.bfloat16), \
            bh.to(torch.bfloat16)
    ah = A.attention_project(h, wh, bh)
    ref = A.attention_project_ref(h, wh, bh)
    err = (ah - ref).abs()
    if (err > 1e-5 + 1e-5 * ref.abs()).any():
        fail(f"attention_project Q={Q} disagrees with its plain version: max "
             f"|d| {err.max().item():.3g}")
    bound = project_bound_ms(Q, *wh.shape, bf16=bf16)
    res = {"max_abs_err": err.max().item(),
           "ms": cuda_ms(lambda: A.attention_project(h, wh, bh)),
           "plain_ms": cuda_ms(lambda: A.attention_project_ref(h, wh, bh)),
           "library_ms": cuda_ms(lambda: torch.addmm(lib_bh, h, wh)),
           "bound_ms": bound[0], "bound_by": bound[1]}
    plan = (A.project_plan_bf16 if bf16 else A.project_plan)(Q, *wh.shape)
    print(f"projection stage{' bf16' if bf16 else ''} Q={Q:4d} {plan}: kernel "
          f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, torch.addmm "
          f"{res['library_ms']:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}), "
          f"max |err| {res['max_abs_err']:.3g}")
    return res


def attention_inputs(params, layout, S, G, seed, beams=2, bf16=False):
    """Kernel inputs at full width: h in (-1, 1) like an LSTM output, the
    model's own h2att/alpha_net weights, projected node streams; with
    ``bf16`` the streams, h, wh and v in bfloat16 (the bf16 chain)."""
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
    x = [h, p_att, att, mask, idx.to(torch.int32), dec["h2att"]["w"],
         dec["h2att"]["b"], dec["alpha_net"]["w"], dec["alpha_net"]["b"]]
    return [t.to(torch.bfloat16) if bf16 and i in (0, 1, 2, 5, 7) else t
            for i, t in enumerate(x)]


def compare_and_time(label, kernel, plain, x, bound, w_atol=1e-5,
                     out_rtol=1e-4, out_atol=1e-4, round_out=False):
    """A kernel against its plain version on the same card inputs (float32:
    weights atol 1e-5, att_res rtol/atol 1e-4; the shared bf16 kernel,
    ``BF16_SHARED_TOL``: weights atol 2e-3, att_res rounded to bf16 as its
    consumer rounds it, rtol 1e-2); times both."""
    import torch
    out, w = kernel(*x)
    r_out, r_w = plain(*x)
    if round_out:
        out, r_out = (t.to(torch.bfloat16).float() for t in (out, r_out))
    w_err = (w - r_w).abs().max().item()
    o_err = (out - r_out).abs()
    bad = (o_err > out_atol + out_rtol * r_out.abs()).sum().item()
    if not (w_err <= w_atol and bad == 0):
        fail(f"{label} disagrees with its plain version: max |dw| "
             f"{w_err:.3g}, {bad} att_res entries out of rtol {out_rtol} "
             f"/ atol {out_atol}")
    res = {"max_abs_err": max(w_err, o_err.max().item()),
           "ms": cuda_ms(lambda: kernel(*x)),
           "plain_ms": cuda_ms(lambda: plain(*x)),
           "bound_ms": bound[0], "bound_by": bound[1]}
    print(f"{label}: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} "
          f"ms, bound {bound[0]:.4f} ms ({bound[1]}), max |err| "
          f"{res['max_abs_err']:.3g}")
    return res


def check_attention(params, layout, S, G, seed=0, beams=2, bf16=False):
    """The beam-shared kernel against its plain version on the card (with
    ``bf16`` its bf16 variant, at ``BF16_SHARED_TOL``)."""
    from subgc_tpu_torch.ops import attention as A
    x = attention_inputs(params, layout, S, G, seed, beams, bf16)
    _, B, R = x[0].shape
    G_, N, H = x[1].shape
    plan = A.attention_plan(S, B, G_, R, H, bf16=bf16)
    dims = (S, B, R, G_, N, H, x[2].shape[-1])
    res = compare_and_time(
        f"attention kernel{' bf16' if bf16 else ''} {layout:8s} S={S:4d} "
        f"G={G:4d} B={B} {plan}",
        A.shared_attention, A.shared_attention_ref, x,
        attention_bound_ms(*dims, bf16=bf16),
        **(BF16_SHARED_TOL if bf16 else {}))
    if bf16:
        res["bound_f32_peak_ms"] = attention_bound_ms(
            *dims, bf16=True, peak=F32_PEAK)[0]
        h2 = x[0].reshape(-1, R)
        res.update(stage_ms(
            res["ms"], lambda: A.run_attention_project(h2, x[5], x[6], plan),
            lambda: A.shared_attention(*x)))
    return res


def check_row_attention(params, R, seed=0, bf16=False):
    """The per-row kernel against its plain version on the card at full
    width (left-packed sub-graph masks); with ``bf16`` its bf16 variant
    (bf16 streams, float32 math: the float32 tolerances)."""
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
    if bf16:
        x = [t.to(torch.bfloat16) if i in (0, 1, 2, 4, 6) else t
             for i, t in enumerate(x)]
    plan = A.attention_plan(R, 1, R, Hin, H, bf16=bf16)
    res = compare_and_time(
        f"row attention kernel{' bf16' if bf16 else ''} R={R:4d} {plan}",
        A.row_attention, A.row_attention_ref, x,
        row_attention_bound_ms(R, Hin, n, H, D, bf16=bf16))
    if bf16:
        res["bound_f32_peak_ms"] = row_attention_bound_ms(
            R, Hin, n, H, D, bf16=True, peak=F32_PEAK)[0]
        res.update(stage_ms(
            res["ms"],
            lambda: A.run_attention_project(x[0], x[4], x[5], plan),
            lambda: A.row_attention(*x)))
    return res


def check_project_launches(path, launches):
    """Every attention launch of a path formed its h @ wh with the
    projection kernel, and nothing else launched it."""
    from subgc_tpu_torch.ops import attention as A
    if A.PROJECT_LAUNCHES != launches:
        fail(f"{path}: projection kernel launched {A.PROJECT_LAUNCHES} "
             f"times for {launches} attention launches")


# the split-TF32 GEMM's launches and weight preparations on each checked
# path, by label
GEMM_COUNTS = {}
GEMM_PREPS = {}


def reset_gemm():
    """Zero the split-TF32 GEMM's launch counter, just before a path."""
    from subgc_tpu_torch.ops import gemm as GM
    GM.reset_launch_counts()


def check_gemm_launches(label, rows, steps, per_step=7, calls=1):
    """The split-TF32 GEMM launched, since :func:`reset_gemm`, as a float32
    decode without gradient of ``steps`` steps over ``rows`` rows a step
    must: ``per_step`` a step (7, or 6 where the word's product is hoisted
    out of the steps) from ``decoder.SPLIT_GEMM_MIN_ROWS`` rows up, none
    below; and its weights were prepared once a decode call, ``per_step``
    preparations a call.  ``rows``: one count for every step of ``calls``
    decode calls, or a list of each decode's rows (:func:`dispatch_rows`),
    ``steps`` then one decode's; 0: a path that must not launch it (bf16,
    training).  Records the launch count in :data:`GEMM_COUNTS`, the
    preparations in :data:`GEMM_PREPS`."""
    from subgc_tpu_torch.models import decoder as D
    from subgc_tpu_torch.ops import gemm as GM
    taken = [r for r in np.atleast_1d(rows)
             if r and r >= D.SPLIT_GEMM_MIN_ROWS]
    want = per_step * steps * len(taken)
    preps = per_step * len(taken) * (calls if np.ndim(rows) == 0 else 1)
    if GM.GEMM_LAUNCHES != want:
        fail(f"{label}: split-TF32 GEMM launched {GM.GEMM_LAUNCHES} times, "
             f"expected {want} ({steps} steps of {rows} rows, the kernel "
             f"from {D.SPLIT_GEMM_MIN_ROWS} rows)")
    if GM.GEMM_WEIGHT_PREPS != preps:
        fail(f"{label}: split-TF32 weights prepared {GM.GEMM_WEIGHT_PREPS} "
             f"times, expected {preps} ({per_step} a decode call of "
             f"{rows} rows)")
    GEMM_COUNTS[label] = want
    GEMM_PREPS[label] = preps
    return want


def dispatch_rows(preds, batch, beams=1, slots=None):
    """The rows each dispatch of a ``run_test_split`` decodes, from its
    predictions (split order): its images' kept sub-graphs, one caption
    each, the last dispatch's padding images repeating its last image,
    times the beams.  ``slots``: a beam search's keep slots an image; the
    kept rows are then rounded up as the runner rounds them on the card
    (``eval/runner.py::BEAM_ROW_BUCKET``, at most every slot)."""
    from subgc_tpu_torch.eval.runner import BEAM_ROW_BUCKET
    kept = [len(p["caption"]) for p in preds]
    out = []
    for c in (kept[i:i + batch] for i in range(0, len(kept), batch)):
        n = sum(c) + (batch - len(c)) * c[-1]
        if slots is not None and 0 < n < batch * slots:
            n = min(-(-n // BEAM_ROW_BUCKET) * BEAM_ROW_BUCKET,
                    batch * slots)
        out.append(beams * n)
    return out


def serving_rows(kept, beams):
    """The most rows a serving dispatch of ``SERVE_BATCH`` images can
    decode (which images share one is the batcher's): the images' largest
    ``kept`` counts (captions an image), times the beams."""
    return beams * sum(sorted(kept)[-SERVE_BATCH:])


def run_split_gemm(params, cfg):
    """Phase 28: the split-TF32 GEMM at decode_step's seven products, at
    :data:`SPLIT_GEMM_ROWS`' rows, on the weights as the model stores them
    (the LSTM input slices rows 4,000 floats apart).  Each weight is first
    prepared (``prepare_weight``: its TF32 halves, transposed; timed, with
    the bytes it reads and writes, beside ``prepare_weight_ref``, whose
    planes it must equal bit for bit), as a decode call does once; the
    decode's path, the kernel on the prepared weight, is timed (``ms``)
    beside the call on the raw weight, which prepares it every call
    (``raw_ms``), and must give the same bits.  Each against float64: its
    largest error at most 4x that of torch's float32 product (TF32 off),
    which is also timed as the library yardstick; the plain version
    (``split_gemm_ref``, three float32 products on the card) timed beside
    it.  ``bound_ms``: max(compulsory bytes / HBM, 2 M N K / the TF32
    tensor-core peak); ``bound_3x_ms`` the same with the three passes' 3 x
    2 M N K, and ``bound_3x_share`` it over ``ms``.  Then the row sweep
    behind ``decoder.SPLIT_GEMM_MIN_ROWS`` (:func:`split_gemm_sweep`)."""
    import torch
    from subgc_tpu_torch.models import decoder as D
    from subgc_tpu_torch.ops import gemm as GM
    dec = params["decoder"]
    R = cfg.rnn_size
    att, lang = dec["att_lstm"], dec["lang_lstm"]
    products = [("att_x", att["w_ih"][2 * R:], None),
                ("att_h", att["w_ih"][:R], None),
                ("att_hh", att["w_hh"], att["b_hh"]),
                ("lang_a", lang["w_ih"][:R], None),
                ("lang_h", lang["w_ih"][R:], None),
                ("lang_hh", lang["w_hh"], lang["b_hh"]),
                ("logit", dec["logit"]["w"], dec["logit"]["b"])]
    prepared, preps = {}, []
    for name, w, _ in products:
        Kw, N = w.shape
        prepared[name] = GM.prepare_weight(w)
        if not torch.equal(prepared[name].planes,
                           GM.prepare_weight_ref(w).planes):
            fail(f"split_gemm preparation {name}: the kernel's planes "
                 f"differ from prepare_weight_ref's")
        nbytes = 4 * (Kw * N + prepared[name].planes.numel())
        ms = cuda_ms(lambda: GM.prepare_weight(w))
        preps.append({"product": name, "K": Kw, "N": N, "ms": ms,
                      "plain_ms": cuda_ms(lambda: GM.prepare_weight_ref(w)),
                      "bound_ms": 1e3 * nbytes / HBM_RATE,
                      "bytes": nbytes, "gb_per_s": nbytes / ms * 1e-6})
        print(f"split_gemm preparation {name}: K {Kw} N {N} {ms:.4f} ms, "
              f"plain {preps[-1]['plain_ms']:.4f} ms, {nbytes / 1e6:.1f} MB "
              f"read and written ({preps[-1]['gb_per_s']:.0f} GB/s), "
              f"planes equal to the plain version's")
    prep = {k: sum(p[k] for p in preps) for k in ("ms", "plain_ms",
                                                    "bound_ms")}
    prep_mb = sum(p["bytes"] for p in preps) / 1e6
    print(f"split_gemm preparation of a decode call's seven weights: "
          f"{prep['ms']:.4f} ms, plain {prep['plain_ms']:.4f} ms, "
          f"{prep_mb:.1f} MB (bound {prep['bound_ms']:.4f} ms at HBM rate)")
    g = torch.Generator(device="cuda").manual_seed(28)
    rows = []
    for cell, M in SPLIT_GEMM_ROWS.items():
        route = ("split_gemm" if M >= D.SPLIT_GEMM_MIN_ROWS
                 else "torch.matmul")
        for name, w, b in products:
            Kw, N = w.shape
            pw = prepared[name]
            x = torch.rand((M, Kw), device="cuda", generator=g) * 2 - 1
            ref = x.double() @ w.double()
            if b is not None:
                ref = ref + b.double()

            def lib():
                return x @ w if b is None else x @ w + b

            y = GM.split_gemm(x, pw, b)
            if not torch.equal(y, GM.split_gemm(x, w, b)):
                fail(f"split_gemm {cell} {name}: the prepared weight's "
                     f"product differs from the raw weight's")
            err = (y.double() - ref).abs().max()
            f32 = (lib().double() - ref).abs().max()
            if err > 4 * f32:
                fail(f"split_gemm {cell} {name}: error {err:.3g} above 4x "
                     f"torch float32's {f32:.3g}")
            ms = cuda_ms(lambda: GM.split_gemm(x, pw, b))
            flops = 2 * M * N * Kw
            nbytes = 4 * (M * Kw + N * Kw + M * N)
            bound, by = _bound(nbytes, flops, TF32_PEAK)
            bound_3x = _bound(nbytes, 3 * flops, TF32_PEAK)[0]
            rows.append({
                "cell": cell, "product": name, "M": M, "K": Kw, "N": N,
                "decode_route": route, "ms": ms,
                "raw_ms": cuda_ms(lambda: GM.split_gemm(x, w, b)),
                "tflops": flops / ms * 1e-9, "bound_ms": bound,
                "bound_by": by, "bound_3x_ms": bound_3x,
                "bound_3x_share": bound_3x / ms,
                "plain_ms": cuda_ms(lambda: GM.split_gemm_ref(x, w, b),
                                    runs=5),
                "library_ms": cuda_ms(lib),
                "max_abs_err": float(err), "library_max_abs_err": float(f32)})
            print(f"split_gemm {cell} {name}: M {M} K {Kw} N {N} "
                  f"{ms:.4f} ms ({rows[-1]['tflops']:.1f} TFLOP/s, "
                  f"{100 * bound_3x / ms:.1f}% of 3 passes' bound "
                  f"{bound_3x:.4f}), raw weight {rows[-1]['raw_ms']:.4f}, "
                  f"torch.matmul {rows[-1]['library_ms']:.4f} ms, bound "
                  f"{bound:.4f} ({by}); error {err:.3g} (torch {f32:.3g}); "
                  f"the decode takes {route}")
    return rows, split_gemm_sweep(products, prepared), {
        "products": preps, **prep, "mb": prep_mb}


# rows of the sweep behind decoder.SPLIT_GEMM_MIN_ROWS
SPLIT_GEMM_SWEEP = (128, 256, 320, 512, 768, 1000, 1024, 1536, 2048, 4096,
                    4860, 16000)


def split_gemm_sweep(products, prepared):
    """The seven products of one decode step at each of
    :data:`SPLIT_GEMM_SWEEP`'s rows (4,860: ``sub_gc.mrnn_test``'s kept
    rows): the card's ms of the kernel on the prepared weights (the
    decode's path) and of torch's float32 product (:func:`cuda_ms`, summed
    over the seven; the first, N = 4,000, also alone, with its TFLOP/s),
    and the host's us a call of each (the mean of 2,000 calls at 4 x 64 x
    64, where the card keeps up).  Prints the least rows from which the
    kernel's step takes less card time than torch's by more than the
    kernel's extra host time; ``decoder.SPLIT_GEMM_MIN_ROWS`` is set from
    it."""
    import torch
    from subgc_tpu_torch.models import decoder as D
    from subgc_tpu_torch.ops import gemm as GM

    def host_us(fn, n=2000):
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return 1e6 * (t1 - t0) / n

    xs = torch.rand((4, 64), device="cuda")
    ws, bs = torch.rand((64, 64), device="cuda"), torch.rand(64,
                                                            device="cuda")
    pws = GM.prepare_weight(ws)
    host = {"split_gemm": host_us(lambda: GM.split_gemm(xs, pws)),
            "split_gemm_bias": host_us(lambda: GM.split_gemm(xs, pws, bs)),
            "matmul": host_us(lambda: xs @ ws),
            "matmul_bias": host_us(lambda: xs @ ws + bs)}
    extra_ms = 1e-3 * (5 * (host["split_gemm"] - host["matmul"])
                       + 2 * (host["split_gemm_bias"] - host["matmul_bias"]))
    print(f"split_gemm host us a call on a prepared weight: "
          f"{host['split_gemm']:.2f} (with bias "
          f"{host['split_gemm_bias']:.2f}); torch.matmul "
          f"{host['matmul']:.2f} (x @ w + b {host['matmul_bias']:.2f}); "
          f"the kernel's step adds {1e3 * extra_ms:.1f} us of host time")
    g = torch.Generator(device="cuda").manual_seed(29)
    sweep, wins = [], None
    for M in SPLIT_GEMM_SWEEP:
        ms = []
        for name, w, b in products:
            x = torch.rand((M, w.shape[0]), device="cuda", generator=g)
            pw = prepared[name]
            ms.append((cuda_ms(lambda: GM.split_gemm(x, pw, b), runs=11),
                       cuda_ms(lambda: x @ w if b is None else x @ w + b,
                               runs=11)))
        k_ms, l_ms = (sum(t[i] for t in ms) for i in (0, 1))
        Kw, N = products[0][1].shape
        first = 2 * M * N * Kw / ms[0][0] * 1e-9
        Nl = products[-1][1].shape[1]
        logit = 2 * M * Nl * Kw / ms[-1][0] * 1e-9
        win = l_ms - k_ms > extra_ms
        if win and wins is None:
            wins = M
        elif not win:
            wins = None
        sweep.append({"M": M, "kernel_ms": k_ms, "library_ms": l_ms,
                      "first_kernel_ms": ms[0][0],
                      "first_library_ms": ms[0][1], "first_tflops": first,
                      "logit_kernel_ms": ms[-1][0], "logit_tflops": logit})
        print(f"split_gemm sweep: {M} rows, the step's seven products "
              f"{k_ms:.4f} ms on the kernel, {l_ms:.4f} ms on torch.matmul; "
              f"{Kw} x {N} alone {ms[0][0]:.4f} ms ({first:.1f} TFLOP/s), "
              f"torch.matmul {ms[0][1]:.4f}; logit {ms[-1][0]:.4f} ms "
              f"({logit:.1f} TFLOP/s)")
    print(f"split_gemm sweep: the kernel's step wins from {wins} rows up "
          f"(SPLIT_GEMM_MIN_ROWS {D.SPLIT_GEMM_MIN_ROWS})")
    return {"host_us": host, "rows": sweep, "wins_from": wins,
            "min_rows": D.SPLIT_GEMM_MIN_ROWS}


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


def check_predictions(preds, n_images, keep, bucket=BUCKET, nonempty=True):
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
        if not all(isinstance(c, str) and (c or not nonempty)
                   for c in p["caption"]):
            fail(f"image {p['image_id']}: empty caption")


def check_sampled_tokens(label, preds, vocab, ecfg):
    """What holds for trained weights too: every caption is
    ``decode_sequence`` of its tokens, every token lies in the vocabulary
    (0 = EOS) and nothing follows a caption's first EOS."""
    from subgc_tpu_torch import decode_sequence
    for p in preds:
        tok = np.asarray(p["tokens"])
        if tok.min() < 0 or tok.max() > len(vocab):
            fail(f"{label}: image {p['image_id']} has tokens outside the "
                 f"vocabulary: {tok.min()}..{tok.max()}")
        ended = np.cumsum(tok == 0, axis=1) > 0
        if (tok[ended] != 0).any():
            fail(f"{label}: image {p['image_id']} has tokens after an EOS")
        caps = decode_sequence(vocab, tok,
                               remove_bad_endings=ecfg.remove_bad_endings)
        if caps != list(p["caption"]):
            fail(f"{label}: image {p['image_id']}'s captions are not its "
                 f"tokens decoded")


def phase_times(params, state, examples, cfg, ecfg, device):
    """Median ms of encoder+sGPN+NMS and of the decode of the kept rows as
    the runner decodes them (beam search, or greedy / top-k at beam_size
    1), one batch."""
    import torch
    from subgc_tpu_torch.eval.runner import _decode, _stack_examples
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
            _decode(params, enc.feats, enc.keep_valid, cfg, ecfg)
            torch.cuda.synchronize()
            enc_ms.append(1e3 * (t1 - t0))
            dec_ms.append(1e3 * (time.perf_counter() - t1))
    return statistics.median(enc_ms[1:]), statistics.median(dec_ms[1:])


GRAPH_RUNS = 20          # phase 29: timed searches each way
# phase 30: a test cell's dispatch, and each test cell's NMS threshold and
# keep
SGPN_IMAGES = 16
SGPN_BUCKET = 1024
SGPN_CELLS = {"sub_gc.kar_test": (0.75, 10), "sub_gc.mrnn_test": (0.55, 1000)}


def sgpn_inputs(n_obj, L, seed=30, B=SGPN_IMAGES, S=SGPN_BUCKET):
    """A test dispatch's sGPN inputs as numpy arrays: (x [B, n_obj, L] >= 0,
    obj_ind and att_mask [B, S, n_obj], valid and scores [B, S]), each
    image's bank of 1,000 sub-graphs sampled over n_obj - 1 detections and
    64 relations, in the test loader's layout (an even count of real ones,
    padded slots on the dummy node with its mask 1, invalid)."""
    from subgc_tpu_torch.data.subgraph_sampler import sample_subgraph_bank
    rng = np.random.RandomState(seed)
    N = n_obj
    oi = np.full((B, S, N), N - 1, np.int64)
    am = np.zeros((B, S, N), np.float32)
    am[:, :, 0] = 1.0
    valid = np.zeros((B, S), bool)
    for b in range(B):
        subj = rng.randint(0, N - 1, 64)
        rels = np.stack([subj, (subj + rng.randint(1, N - 1, 64)) % (N - 1)],
                        1)
        nouns = [rng.choice(N - 1, rng.randint(1, 4), replace=False)
                 for _ in range(5)]
        bank = sample_subgraph_bank(N - 1, rels, nouns, 1000,
                                    seed=int(rng.randint(1 << 30)))
        sets = [np.nonzero(e[1])[0] for e in bank["subgraph_mask_list"][5:]]
        n = 2 * (len(sets) // 2)
        for s, nodes in enumerate(sets[:n]):
            oi[b, s, :len(nodes)] = nodes
            am[b, s] = 0.0
            am[b, s, :len(nodes)] = 1.0
        valid[b, :n] = True
    x = np.maximum(rng.randn(B, N, L), 0).astype(np.float32)
    scores = rng.rand(B, S).astype(np.float32)
    return x, oi, am, valid, scores


def run_sgpn(params, cfg):
    """Phase 30 (the module docstring); returns its numbers."""
    import torch
    from subgc_tpu_torch.models import gpn as G
    from subgc_tpu_torch.ops import sgpn as SG
    x, oi, am, valid, scores = (torch.from_numpy(a).cuda() for a in
                                sgpn_inputs(cfg.obj_num, cfg.gcn_dim))
    B, S, N = oi.shape
    n_obj, L = x.shape[-2:]

    def torch_route(fn):
        saved = G._on_card
        G._on_card = lambda t: False
        try:
            return fn()
        finally:
            G._on_card = saved

    def broadcast():            # the torch route's max half
        return G.masked_max(x, G.node_membership(oi, am, n_obj))

    def peak_bytes(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    out = torch.empty((B, S, L), device="cuda")
    if not torch.equal(SG.readout_max(x, oi, am, out=out), broadcast()):
        fail("sgpn: the read-out kernel differs from the masked broadcast")
    nbytes = 4 * (x.numel() + am.numel() + B * S * L) + 8 * oi.numel()
    readout = {
        "B": B, "S": S, "n_obj": n_obj, "L": L,
        "ms": cuda_ms(lambda: SG.readout_max(x, oi, am, out=out)),
        "torch_path_ms": cuda_ms(broadcast),
        "bound_ms": 1e3 * nbytes / HBM_RATE, "bound_by": "bytes",
        "bytes": nbytes,
        "peak_bytes": peak_bytes(lambda: SG.readout_max(x, oi, am, out=out)),
        "torch_path_peak_bytes": peak_bytes(broadcast)}
    print(f"sgpn read-out max {B} x {S} x {n_obj} x {L}: "
          f"{readout['ms']:.4f} ms (bound {readout['bound_ms']:.4f} ms, "
          f"bytes), torch path {readout['torch_path_ms']:.4f} ms; peak "
          f"{readout['torch_path_peak_bytes'] / 1e9:.2f} GB -> "
          f"{readout['peak_bytes'] / 1e9:.3f} GB; bit for bit")

    rounds = []

    class Counting:             # gpn's span: counts the NMS rounds
        def __init__(self, name):
            if name == "subgc.gpn.nms_round":
                rounds.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    cells = {}
    s = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    order = torch.sort(-s, dim=-1, stable=True).indices
    for cell, (thres, keep) in SGPN_CELLS.items():
        def nms():
            return G.subgraph_nms(scores, oi, am, valid, cfg, thres, keep)

        def sgpn_nms():
            out = G.gpn_test_forward(params, x, oi, am, cfg)
            return (out.read_out, out.scores,
                    *G.subgraph_nms(out.scores, oi, am, valid, cfg, thres,
                                    keep))

        saved, G.span = G.span, Counting
        try:
            rounds.clear()
            got = nms()
            kernel_rounds = len(rounds)
            rounds.clear()
            want = torch_route(nms)
            torch_rounds = len(rounds)
        finally:
            G.span = saved
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"sgpn {cell}: the NMS kernel's keep sets differ from the "
                 f"torch fixpoint's")
        if not all(torch.equal(a, b) for a, b in
                   zip(sgpn_nms(), torch_route(sgpn_nms))):
            fail(f"sgpn {cell}: the kernel route's read-out, scores or keep "
                 f"sets differ from the torch route's")
        nbytes = B * S * (8 + 12 * N + 2)
        k = min(keep, S)
        cells[cell] = {
            "thres": thres, "keep": keep,
            "kept_per_image": got[1].sum().item() / B,
            "ms": cuda_ms(lambda: SG.nms_keep_sorted(
                order, oi, am, valid, thres, k, n_obj)),
            "bound_ms": 1e3 * nbytes / HBM_RATE, "bound_by": "bytes",
            "nms_ms": cuda_ms(nms), "torch_nms_ms": cuda_ms(
                lambda: torch_route(nms)),
            "rounds": kernel_rounds, "torch_rounds": torch_rounds,
            "sgpn_nms_ms": cuda_ms(sgpn_nms),
            "torch_sgpn_nms_ms": cuda_ms(lambda: torch_route(sgpn_nms))}
        c = cells[cell]
        print(f"sgpn {cell} (NMS {thres}, keep {keep}; "
              f"{c['kept_per_image']:.1f} kept an image): kernel "
              f"{c['ms']:.4f} ms (bound {c['bound_ms']:.4f}); subgraph_nms "
              f"{c['nms_ms']:.3f} ms against {c['torch_nms_ms']:.3f} "
              f"({c['torch_rounds']} rounds); sGPN + NMS "
              f"{c['sgpn_nms_ms']:.3f} ms against "
              f"{c['torch_sgpn_nms_ms']:.3f}; keep sets, read-outs and "
              f"scores equal")
    return {"readout_max": readout, "subgraph_nms": cells}


def run_graphs(params, state, examples, cfg, ecfg):
    """Phase 29 (the module docstring); returns its numbers."""
    import torch
    from subgc_tpu_torch.decode import beam as beam_mod
    from subgc_tpu_torch.decode import graphs as GR
    from subgc_tpu_torch.eval.runner import _stack_examples
    from subgc_tpu_torch.graph import to_device
    from subgc_tpu_torch.models.subgc import encode_images_batched
    from subgc_tpu_torch.ops import attention as A
    graph, subs = (to_device(x, "cuda")
                   for x in _stack_examples(examples[:BATCH_IMAGES]))
    with torch.no_grad():
        feats = encode_images_batched(params, state, graph, subs, cfg,
                                      ecfg).feats
    rows = feats.fc.shape[0]

    def timed(eager):
        walls, hosts = [], []
        for _ in range(GRAPH_RUNS):
            if eager:
                GR.SEARCHES.clear()     # every call a key's first
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = beam_mod.beam_search(params, feats, cfg, ecfg)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            hosts.append(1e3 * (t1 - t0))
        return (out, statistics.median(walls[2:]),
                statistics.median(hosts[2:]))

    eager, eager_ms, eager_host = timed(eager=True)
    GR.SEARCHES.clear()
    beam_mod.beam_search(params, feats, cfg, ecfg)      # the key's first
    torch.cuda.synchronize()
    mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    captured = beam_mod.beam_search(params, feats, cfg, ecfg)
    torch.cuda.synchronize()
    capture_ms = 1e3 * (time.perf_counter() - t0)
    chain_bytes = torch.cuda.memory_allocated() - mem
    A.reset_launch_counts()
    reset_gemm()
    replayed, graph_ms, graph_host = timed(eager=False)
    torch.cuda.synchronize()
    for way, out in (("capture", captured), ("replay", replayed)):
        for name, a, b in zip(eager._fields, out, eager):
            if a.shape != b.shape or not torch.equal(a, b):
                fail(f"graphs: the {way}'s {name} differs from the eager "
                     f"search's")
    if len(GR.SEARCHES) != 1:
        fail(f"graphs: {len(GR.SEARCHES)} chains kept for one key")
    launches = A.LAUNCHES
    if launches != GRAPH_RUNS * cfg.seq_length or A.ROW_LAUNCHES:
        fail(f"graphs: attention kernel launched {launches} times in "
             f"{GRAPH_RUNS} replayed searches (row kernel "
             f"{A.ROW_LAUNCHES}), expected {GRAPH_RUNS} x "
             f"{cfg.seq_length} (and 0)")
    check_project_launches("graphs", launches)
    check_gemm_launches("graphs", rows * ecfg.beam_size, cfg.seq_length,
                        calls=GRAPH_RUNS)
    stats = {"rows": rows, "beams": ecfg.beam_size,
             "eager_ms": round(eager_ms, 4),
             "eager_host_ms": round(eager_host, 4),
             "graph_ms": round(graph_ms, 4),
             "graph_host_ms": round(graph_host, 4),
             "capture_call_ms": round(capture_ms, 2),
             "chain_bytes": chain_bytes, "attention_launches": launches}
    print(f"graphs: {rows} rows x {ecfg.beam_size} beams, bit for bit the "
          f"eager search's; eager {eager_ms:.2f} ms (host "
          f"{eager_host:.2f}), graphs {graph_ms:.2f} ms (host "
          f"{graph_host:.2f}); capture call {capture_ms:.1f} ms, "
          f"{chain_bytes / 2**20:.1f} MiB; attention launches {launches}")
    return stats


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
    A.LAUNCHES = A.ROW_LAUNCHES = A.PROJECT_LAUNCHES = 0
    reset_gemm()
    preds, wall, n_caps = run_test_split(
        params, state, loader, cfg, ecfg, vocab, verbose=False,
        batch_images=BATCH_IMAGES, device="cuda", collect_grounding=col)
    launches, beam_launches = A.ROW_LAUNCHES, A.LAUNCHES
    n_dispatch = -(-len(examples) // BATCH_IMAGES)
    check_gemm_launches("grounding path",
                        dispatch_rows(preds, BATCH_IMAGES, ecfg.beam_size),
                        cfg.seq_length + 1)
    if launches != n_dispatch * (cfg.seq_length + 1) or beam_launches:
        fail(f"grounding path: row kernel launched {launches} times, beam "
             f"kernel {beam_launches}; expected {n_dispatch} dispatches x "
             f"{cfg.seq_length + 1} steps and 0")
    check_project_launches("grounding path", launches)
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
    from subgc_tpu_torch.models import decoder as D
    from subgc_tpu_torch.ops import attention as A
    cfg, ecfg, _ = build_configs("Sub_GC_MRNN",
                                 eval=dict(max_subgraph_bucket=FANOUT_BUCKET))
    examples = make_examples(cfg, FANOUT_IMAGES, FANOUT_BUCKET, seed=1)
    loader = MemoryLoader(examples)
    run_test_split(params, state, loader, cfg, ecfg, vocab,
                   num_images=FANOUT_BATCH, verbose=False,
                   batch_images=FANOUT_BATCH, device="cuda")    # warm-up
    torch.cuda.synchronize()
    A.LAUNCHES = A.ROW_LAUNCHES = A.PROJECT_LAUNCHES = 0
    reset_gemm()
    preds, wall, n_caps = run_test_split(
        params, state, loader, cfg, ecfg, vocab, verbose=False,
        batch_images=FANOUT_BATCH, keep_tokens=True, device="cuda")
    launches, row_launches = A.LAUNCHES, A.ROW_LAUNCHES
    n_dispatch = -(-FANOUT_IMAGES // FANOUT_BATCH)
    # the M-RNN decode's rows: each dispatch's kept sub-graphs
    rows = dispatch_rows(preds, FANOUT_BATCH)
    if min(rows) < D.SPLIT_GEMM_MIN_ROWS:
        fail(f"fan-out path: dispatches of {rows} kept rows; the check needs "
             f"{D.SPLIT_GEMM_MIN_ROWS} or more in each")
    check_gemm_launches("fan-out path", rows, cfg.seq_length)
    if launches != n_dispatch * cfg.seq_length or row_launches:
        fail(f"fan-out path: beam-shared kernel launched {launches} times, "
             f"row kernel {row_launches}; expected {n_dispatch} dispatches "
             f"x {cfg.seq_length} steps and 0")
    check_project_launches("fan-out path", launches)
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
        batch_images=FANOUT_BATCH, keep_tokens=True, device="cuda")
    check_predictions(preds, len(examples), ecfg.gpn_max_subg, FANOUT_BUCKET,
                      nonempty=False)
    check_sampled_tokens("top-k at the_k=3", preds, vocab, ecfg)
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
          f"{n_caps / wall:.1f} captions/s, each its tokens decoded, "
          f"nothing after an EOS; {lp.numel()} recorded logprobs finite and "
          f"<= 0")


def make_sct_examples(cfg, n_images, bucket, seed, gt=False):
    """Synthetic test images with 2-5 region sets each, made from the
    image's own detector boxes (tests/test_cli_sct.py), turned into
    sub-graphs by the port's ``data/sct.py``: greedily, or (``gt``) by
    look-up among five GT sub-graphs whose seed boxes the region sets are,
    so the look-up succeeds (tests/test_gt_subg.py)."""
    from subgc_tpu_torch.data.dataset import ImageInfo, TestExample
    from subgc_tpu_torch.data.sct import sct_subgraph_set
    from subgc_tpu_torch.graph import make_scene_graph
    rng = np.random.RandomState(seed)
    N, K = cfg.obj_num, cfg.rel_num
    n, k = N - 1, K - 1                  # 36 detections, 64 relations
    out = []
    for i in range(n_images):
        obj_dist = rng.rand(n, cfg.num_obj_classes).astype("f")
        rel_ind = rng.randint(0, n, (k, 2)).astype(np.int64)
        graph = make_scene_graph(
            rng.rand(n, cfg.att_feat_size).astype("f"), obj_dist, rel_ind,
            rng.rand(k, cfg.num_rel_classes).astype("f"), N, K)
        boxes = rng.rand(n, 4).astype("f") * 296
        boxes[:, 2:] += boxes[:, :2]
        n_sets = rng.randint(2, 6)
        gt_masks = None
        if gt:
            gt_masks = []
            for _ in range(5):
                nodes = rng.choice(n, rng.randint(2, 8), replace=False)
                obj_mask = np.zeros(n, np.int64)
                obj_mask[nodes] = 1
                pred_mask = (np.isin(rel_ind[:, 0], nodes)
                             & np.isin(rel_ind[:, 1], nodes)).astype(np.int64)
                gt_masks.append([None, obj_mask, pred_mask, None,
                                 nodes[:max(1, len(nodes) // 2)]])
            groups = [boxes[np.unique(gt_masks[g][4])] for g in range(n_sets)]
        else:
            groups = [boxes[rng.choice(n, rng.randint(1, 3), replace=False)]
                      for _ in range(n_sets)]
        sets = np.zeros((n_sets, max(len(g) for g in groups), 5), np.float32)
        for g_i, g in enumerate(groups):
            sets[g_i, :len(g), :4] = g
            sets[g_i, :len(g), 4] = 1
        subs, n_sub = sct_subgraph_set(sets, boxes, obj_dist.argmax(1),
                                       rel_ind, N, K, bucket, gt_masks)
        out.append(TestExample(graph=graph, subs=subs, n_subgraphs=n_sub,
                               info=ImageInfo(ix=i, id=i, file_path=""),
                               gts=np.zeros((0, cfg.seq_length), np.int64),
                               sg_raw={"boxes": boxes}))
    return out


def decode_fullgc(params, state, examples, cfg, ecfg, device):
    """Full_GC_Kar through the port's entry points, one image at a time:
    ``encode_image`` (no sub-graphs) + ``beam_search``.  Returns the best
    beam's tokens [images, T] on the host."""
    import torch
    from subgc_tpu_torch import beam_search, encode_image, to_device
    seqs = []
    with torch.no_grad():
        for ex in examples:
            enc = encode_image(params, state, to_device(ex.graph, device),
                               None, cfg, ecfg)
            seqs.append(beam_search(params, enc.feats, cfg, ecfg).seq[0])
    return torch.stack(seqs).cpu().numpy()


def bn_state_from_seed(state, seed):
    """The GCN BatchNorm running statistics drawn away from (0, 1), as
    tests/test_fullgc_parity.py sets them: mean ~N(0, 0.05), var
    ~U(0.8, 1.2)."""
    rng = np.random.RandomState(seed)
    return {**state, "gcn_bn": [
        [{"mean": rng.normal(0, 0.05, u["mean"].shape).astype("f"),
          "var": rng.uniform(0.8, 1.2, u["var"].shape).astype("f")}
         for u in layer] for layer in state["gcn_bn"]]}


def run_fullgc(vocab):
    """Phase 11: Full_GC_Kar on the card and on the CPU.  Returns the
    beam-shared kernel's launches."""
    import torch
    from subgc_tpu_torch import (build_configs, decode_sequence,
                                 params_from_numpy)
    from subgc_tpu_torch.models.params import init_params_numpy
    from subgc_tpu_torch.ops import attention as A
    cfg, ecfg, _ = build_configs("Full_GC_Kar")
    params_np, state_np = init_params_numpy(cfg, seed=0)
    state_np = bn_state_from_seed(state_np, seed=11)
    params, state = (params_from_numpy(t, "cuda")
                     for t in (params_np, state_np))
    examples = make_examples(cfg, FULLGC_IMAGES, 1, seed=3)
    dev = torch.device("cuda")
    decode_fullgc(params, state, examples[:2], cfg, ecfg, dev)   # warm-up
    torch.cuda.synchronize()
    A.LAUNCHES = A.ROW_LAUNCHES = A.PROJECT_LAUNCHES = 0
    reset_gemm()
    t0 = time.perf_counter()
    seqs = decode_fullgc(params, state, examples, cfg, ecfg, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = A.LAUNCHES
    check_gemm_launches("Full-GC path", ecfg.beam_size,
                        FULLGC_IMAGES * cfg.seq_length, calls=FULLGC_IMAGES)
    if launches != FULLGC_IMAGES * cfg.seq_length or A.ROW_LAUNCHES:
        fail(f"Full-GC path: beam-shared kernel launched {launches} times, "
             f"row kernel {A.ROW_LAUNCHES}; expected {FULLGC_IMAGES} images "
             f"x {cfg.seq_length} steps and 0")
    check_project_launches("Full-GC path", launches)
    caps = decode_sequence(vocab, seqs)
    if len(caps) != FULLGC_IMAGES or not all(isinstance(c, str)
                                             for c in caps):
        fail(f"Full-GC path: {len(caps)} captions for {FULLGC_IMAGES} images")
    print(f"Full-GC path (Full_GC_Kar, beam {ecfg.beam_size}): "
          f"{FULLGC_IMAGES} images, one at a time, in {wall:.3f} s = "
          f"{FULLGC_IMAGES / wall:.1f} captions/s, "
          f"{1e3 * wall / FULLGC_IMAGES:.2f} ms per image; beam-shared "
          f"kernel launches {launches}")

    t0 = time.perf_counter()
    cpu = decode_fullgc(*(params_from_numpy(t, "cpu")
                          for t in (params_np, state_np)),
                        examples, cfg, ecfg, torch.device("cpu"))
    n_same = sum(a == b for a, b in zip(caps, decode_sequence(vocab, cpu)))
    print(f"Full-GC card vs cpu ({time.perf_counter() - t0:.1f} s on cpu): "
          f"{n_same}/{FULLGC_IMAGES} captions identical")
    if n_same < 0.95 * FULLGC_IMAGES:
        fail(f"Full-GC: only {n_same}/{FULLGC_IMAGES} captions agree between "
             f"card and cpu")
    return launches


def check_sct_predictions(preds, examples, label, ones):
    if len(preds) != len(examples):
        fail(f"{label}: {len(preds)} predictions for {len(examples)} images")
    for p, ex in zip(preds, examples):
        ind = np.asarray(p["sorted_subgraph_ind"])
        s = np.asarray(p["subgraph_score"])
        if not np.array_equal(ind, np.arange(ex.n_subgraphs)) \
                or len(p["caption"]) != ex.n_subgraphs:
            fail(f"{label}: image {p['image_id']} has sub-graphs {ind} and "
                 f"{len(p['caption'])} captions for {ex.n_subgraphs} region "
                 f"sets")
        if ones and not (s == 1.0).all():
            fail(f"{label}: image {p['image_id']} scores {s}, expected 1")
        if not (np.isfinite(s).all() and (s > 0).all() and (s <= 1).all()):
            fail(f"{label}: image {p['image_id']}: bad scores {s}")


def run_sct(preset, params_np, state_np, vocab, seed):
    """Phases 12-13: a controllability preset on the card and, on the first
    batch, on the CPU.  Returns the beam-shared kernel's launches and the
    card's predictions."""
    import torch
    from subgc_tpu_torch import build_configs, params_from_numpy, \
        run_test_split
    from subgc_tpu_torch.ops import attention as A
    cfg, ecfg, _ = build_configs(preset,
                                 eval=dict(max_subgraph_bucket=SCT_BUCKET))
    gt = ecfg.use_gt_subg
    params, state = (params_from_numpy(t, "cuda")
                     for t in (params_np, state_np))
    examples = make_sct_examples(cfg, SCT_IMAGES, SCT_BUCKET, seed, gt=gt)
    loader = MemoryLoader(examples)
    run_test_split(params, state, loader, cfg, ecfg, vocab,
                   num_images=BATCH_IMAGES, verbose=False,
                   batch_images=BATCH_IMAGES, device="cuda")    # warm-up
    torch.cuda.synchronize()
    A.LAUNCHES = A.ROW_LAUNCHES = A.PROJECT_LAUNCHES = 0
    reset_gemm()
    preds, wall, n_caps = run_test_split(
        params, state, loader, cfg, ecfg, vocab, verbose=False,
        batch_images=BATCH_IMAGES, device="cuda")
    launches = A.LAUNCHES
    n_dispatch = -(-SCT_IMAGES // BATCH_IMAGES)
    check_gemm_launches(preset,
                        dispatch_rows(preds, BATCH_IMAGES, ecfg.beam_size,
                                      SCT_BUCKET),
                        cfg.seq_length)
    if launches != n_dispatch * cfg.seq_length or A.ROW_LAUNCHES:
        fail(f"{preset}: beam-shared kernel launched {launches} times, row "
             f"kernel {A.ROW_LAUNCHES}; expected {n_dispatch} dispatches x "
             f"{cfg.seq_length} steps and 0")
    check_project_launches(preset, launches)
    check_sct_predictions(preds, examples, preset, ones=gt)
    print(f"{preset}: {SCT_IMAGES} images, {n_caps} captions (bucket "
          f"{SCT_BUCKET}, {BATCH_IMAGES * SCT_BUCKET} rows x "
          f"{ecfg.beam_size} beams a dispatch) in {wall:.3f} s = "
          f"{n_caps / wall:.1f} captions/s, {1e3 * wall / n_dispatch:.2f} ms "
          f"per {BATCH_IMAGES}-image batch; beam-shared kernel launches "
          f"{launches}")

    t0 = time.perf_counter()
    cpu_preds, _, _ = run_test_split(
        *(params_from_numpy(t, "cpu") for t in (params_np, state_np)),
        loader, cfg, ecfg, vocab, num_images=BATCH_IMAGES, verbose=False,
        batch_images=BATCH_IMAGES, device="cpu")
    n_same, n_total = compare_card_cpu(preds[:BATCH_IMAGES], cpu_preds)
    print(f"{preset} card vs cpu ({time.perf_counter() - t0:.1f} s on cpu): "
          f"{n_same}/{n_total} captions identical, sub-graph sets identical")
    if n_same < 0.95 * n_total:
        fail(f"{preset}: only {n_same}/{n_total} captions agree between card "
             f"and cpu")
    return launches, preds


ORACLE = 5                # the oracle-5 protocol (reproduce's default)
METRIC_MAX = {"Bleu_1": 1, "Bleu_2": 1, "Bleu_3": 1, "Bleu_4": 1,
              "METEOR": 1, "ROUGE_L": 1, "CIDEr": 10, "SPICE": 1}
NN_TRAIN = 113287         # Karpathy COCO: 82,783 train + 30,504 restval
NN_TEST = 5000            # Karpathy COCO test images
NN_DIM = 2048             # ResNet-101 pooled features
NN_K = 1000               # the rerank CLI's --num_NN


def seeded_sentences(rng, words, n):
    """n sentences of 6-13 words drawn from ``words`` (a numpy array)."""
    return [" ".join(words[rng.randint(len(words), size=rng.randint(6, 14))])
            for _ in range(n)]


def check_scores(label, scores, n_images):
    for m, top in METRIC_MAX.items():
        a = scores[m]
        if a.shape != (ORACLE, n_images) or not np.isfinite(a).all() \
                or a.min() < 0 or a.max() > top:
            fail(f"{label}: {m} scores of shape {a.shape} in "
                 f"[{a.min()}, {a.max()}], expected ({ORACLE}, {n_images}) "
                 f"in [0, {top}]")
    if not all(np.isfinite(v) for v in scores["oracle"].values()):
        fail(f"{label}: oracle scores {scores['oracle']}")


def run_language_eval(preds, cpu_preds, words):
    """Phase 13a.  Returns (stats, the GT captions by image id)."""
    from subgc_tpu_torch.eval import (bleu, cider, meteor, rouge, spice,
                                      tokenizer)
    from subgc_tpu_torch.eval.sentence import align_predictions, \
        language_eval
    rng = np.random.RandomState(50)
    gts = {p["image_id"]: seeded_sentences(rng, words, 5) for p in preds}
    t0 = time.perf_counter()
    scores = language_eval(gts, align_predictions(preds, ORACLE),
                           verbose=False)
    sec = time.perf_counter() - t0
    check_scores("language eval (card)", scores, len(preds))
    # each scorer alone on the rank-0 captions
    gts_t = tokenizer.tokenize({k: [{"caption": c} for c in v]
                                for k, v in gts.items()})
    res_t = tokenizer.tokenize({p["image_id"]: [{"caption": p["caption"][0]}]
                                for p in preds})
    per_metric = {}
    for name, fn in (("BLEU", bleu.compute_bleu),
                     ("METEOR", meteor.compute_meteor),
                     ("ROUGE_L", rouge.compute_rouge),
                     ("CIDEr", cider.compute_cider),
                     ("SPICE", spice.compute_spice)):
        t1 = time.perf_counter()
        fn(gts_t, res_t)
        per_metric[name] = 1e3 * (time.perf_counter() - t1) / len(preds)

    # the first batch on the card and on the CPU, over the same GT
    card = align_predictions(preds[:len(cpu_preds)], ORACLE)
    cpu = align_predictions(cpu_preds, ORACLE)
    gts1 = {p["image_id"]: gts[p["image_id"]] for p in cpu}
    s_card = language_eval(gts1, card, verbose=False)
    s_cpu = language_eval(gts1, cpu, verbose=False)
    check_scores("language eval (cpu)", s_cpu, len(cpu))
    same = [i for i, (a, b) in enumerate(zip(card, cpu))
            if a["image_id"] == b["image_id"] and a["caption"] == b["caption"]]
    for m in METRIC_MAX:
        if not np.array_equal(s_card[m][:, same], s_cpu[m][:, same]):
            fail(f"language eval: {m} differs between card and cpu on "
                 f"images with identical captions")
    if len(same) < 0.75 * len(cpu):
        fail(f"language eval: only {len(same)}/{len(cpu)} images have the "
             f"same {ORACLE} ranked captions on card and cpu")
    top1 = {m: round(float(v), 4) for m, v in scores["top1"].items()}
    print(f"language eval (oracle {ORACLE}) of {len(preds)} images' card "
          f"captions: {sec:.3f} s on the host = {1e3 * sec / len(preds):.2f} "
          f"ms per image; rank 0 alone, ms per image: " + ", ".join(
              f"{k} {v:.3f}" for k, v in per_metric.items())
          + f"; top-1 {top1}; {len(same)}/{len(cpu)} first-batch images "
          f"with identical ranked captions score identically on card and "
          f"cpu")
    return {"images": len(preds), "oracle_num": ORACLE, "s": sec,
            "ms_per_image": 1e3 * sec / len(preds),
            "rank0_ms_per_image": per_metric,
            "card_cpu_identical_images": len(same),
            "first_batch_images": len(cpu)}, gts


def run_diversity(greedy_preds):
    """Phase 13b."""
    from subgc_tpu_torch.eval.diversity import diversity_report
    t0 = time.perf_counter()
    rep = diversity_report(greedy_preds, evaluate_mb4=True)
    sec = time.perf_counter() - t0
    vals = rep["distinct"] + list(rep["ngram"].values()) + rep["mBLEU4"]
    if not all(np.isfinite(v) and 0 <= v <= 1 for v in vals):
        fail(f"diversity: {rep}")
    print(f"diversity of {len(greedy_preds)} images' card captions "
          f"(Sub_GC_MRNN): {sec:.3f} s on the host; {json.dumps(rep)}")
    return {"images": len(greedy_preds), "s": sec, **rep}


def run_controllability(ctl_preds, words):
    """Phase 13c."""
    from subgc_tpu_torch.eval.controllability import (NounIoU,
                                                      controllability_scores)
    rng = np.random.RandomState(60)
    nouns = {w: rng.randn(300).astype("f") for w in words[::2]}
    groups = [seeded_sentences(rng, words, rng.randint(1, 4))
              for p in ctl_preds for _ in p["caption"]]
    t0 = time.perf_counter()
    out = controllability_scores(ctl_preds, [p["image_id"]
                                             for p in ctl_preds],
                                 groups, NounIoU(nouns))
    sec = time.perf_counter() - t0
    if not (all(np.isfinite(v) for v in out.values())
            and 0 <= out["NounIoU"] <= 1):
        fail(f"controllability: {out}")
    print(f"controllability of {len(groups)} card captions "
          f"(Sub_GC_Flickr_CTL): {sec:.3f} s on the host; "
          + ", ".join(f"{k} {v:.4f}" for k, v in out.items()))
    return {"captions": len(groups), "s": sec, **out}


def nn_distance_ms(te, tr, batch=512):
    """Median device ms of the NN search's distance matmuls alone (every
    chunk's ``|a|^2 + |b|^2 - 2ab``, no selection), CUDA events."""
    import torch
    tr_sq = (tr * tr).sum(-1)
    times = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for i in range(0, te.shape[0], batch):
            a = te[i:i + batch]
            (a * a).sum(-1, keepdim=True) + tr_sq[None, :] - 2.0 * a @ tr.T
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run_nn_search(preds, gts, words):
    """Phase 13d: the rerank NN search at Karpathy COCO size, its exact
    check on integer features, then the consensus step."""
    import torch
    from subgc_tpu_torch.eval.rerank import (consensus_rerank,
                                             find_nn_images,
                                             select_top_captions)
    gen = torch.Generator(device="cuda").manual_seed(70)
    tr = torch.rand((NN_TRAIN, NN_DIM), generator=gen, device="cuda")
    te = torch.rand((NN_TEST, NN_DIM), generator=gen, device="cuda")
    find_nn_images(te[:512], tr, NN_K)                       # warm-up
    ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nn = find_nn_images(te, tr, NN_K)       # returns host indices
        ms.append(1e3 * (time.perf_counter() - t0))
    if nn.shape != (NN_TEST, NN_K) or nn.min() < 0 or nn.max() >= NN_TRAIN \
            or any(len(set(r)) != NN_K for r in nn[:64].tolist()):
        fail(f"NN search: indices of shape {nn.shape} out of range or "
             f"repeated")
    dist_ms = nn_distance_ms(te, tr)
    flops_ms = 1e3 * 2.0 * NN_TEST * NN_TRAIN * NN_DIM / F32_PEAK
    bytes_ms = 1e3 * (4 * (NN_TRAIN + NN_TEST) * NN_DIM + 8 * nn.size) \
        / HBM_RATE
    del tr, te
    torch.cuda.empty_cache()

    rng = np.random.RandomState(71)
    tr_i = rng.randint(-4, 5, (20000, NN_DIM)).astype(np.float32)
    tr_i[10000:12000] = tr_i[0]       # 2,001 rows at one distance ...
    tr_i[15000:17000] = tr_i[1000:3000]
    te_i = rng.randint(-4, 5, (256, NN_DIM)).astype(np.float32)
    te_i[:8] = tr_i[0]                # ... 0 from these: it spans rank 1000
    te_i[8:64] = tr_i[rng.randint(0, 20000, 56)]
    got = find_nn_images(te_i, tr_i, NN_K)
    t64, e64 = tr_i.astype(np.float64), te_i.astype(np.float64)
    d = (e64 * e64).sum(1)[:, None] + (t64 * t64).sum(1)[None] \
        - 2.0 * e64 @ t64.T
    ref = np.argsort(d, axis=1, kind="stable")[:, :NN_K]
    if not np.array_equal(got, ref):
        fail(f"NN search: {int((got != ref).sum())} of {ref.size} ranks "
             f"differ from the float64 reference")

    annos_rng = np.random.RandomState(72)
    ann = words[annos_rng.randint(len(words), size=(20000, 5, 10))]
    annos = [{"id": i, "sentences": [" ".join(s) for s in a]}
             for i, a in enumerate(ann)]
    hypo = select_top_captions(preds[:8], top_k=4)
    t0 = time.perf_counter()
    order = consensus_rerank(hypo, annos, got[:8], gts, k=60, m=125)
    rr_sec = time.perf_counter() - t0
    for h in hypo:
        if sorted(order[h["id"]]) != list(range(len(h["caption"]))):
            fail(f"consensus rerank: image {h['id']} order {order[h['id']]}")
    stats = {"train": NN_TRAIN, "test": NN_TEST, "dim": NN_DIM,
             "num_nn": NN_K, "ms": statistics.median(ms), "runs_ms": ms,
             "distance_ms": dist_ms,
             "bound_ms": max(flops_ms, bytes_ms),
             "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
             "exact_check": "256 x 20000 integer features, ties across "
                            "rank 1000: equal to float64"}
    print(f"rerank NN search: {NN_TEST} x {NN_TRAIN} x {NN_DIM} float32, "
          f"top {NN_K}: median {stats['ms']:.2f} ms (runs "
          f"{', '.join(f'{x:.2f}' for x in ms)}; the distance matmuls "
          f"alone {dist_ms:.2f} ms), bound "
          f"{stats['bound_ms']:.2f} ms ({stats['bound_by']}); integer "
          f"check 256 x 20000 equal to float64 rank for rank; consensus "
          f"rerank of 8 images (k 60, m 125): {rr_sec:.3f} s on the host")
    return stats, {"images": 8, "k": 60, "m": 125, "s": rr_sec}


def run_eval(preds, cpu_preds, greedy_preds, ctl_preds, vocab):
    """Phases 13a-13d on captions decoded by the earlier phases."""
    words = np.asarray([vocab[k] for k in sorted(vocab, key=int)])
    lang, gts = run_language_eval(preds, cpu_preds, words)
    div = run_diversity(greedy_preds)
    ctl = run_controllability(ctl_preds, words)
    nn, rr = run_nn_search(preds, gts, words)
    return {"language_eval": lang, "diversity": div,
            "controllability": ctl, "nn_search": nn, "consensus_rerank": rr}


def _leaf_names(tree, prefix=""):
    """Dotted names of a params tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _leaf_names(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def _loss_and_grads(cfg, params_np, state_np, batch_np, device):
    """Full training loss (language + sGPN) on ``device`` with dropout off
    (``train=True``, no generator), its gradient per parameter leaf (None
    where autograd reaches none) and the new model state, all on the
    host."""
    import torch
    from subgc_tpu_torch import params_from_numpy
    from subgc_tpu_torch.models.params import params_to_numpy
    from subgc_tpu_torch.models.subgc import train_forward
    from subgc_tpu_torch.train.loss import language_model_loss
    from subgc_tpu_torch.train.optim import tree_leaves
    from subgc_tpu_torch.train.step import batch_to_device
    p = params_from_numpy(params_np, device, requires_grad=True)
    b = batch_to_device(batch_np, device)
    lp, gl, _, new_state = train_forward(
        p, params_from_numpy(state_np, device), b.graph, b.labels,
        b.sub_obj_ind, b.sub_att_mask, b.img_ix, cfg, train=True)
    loss = language_model_loss(lp, b.labels[:, 1:], b.masks[:, 1:])
    if gl is not None:
        loss = loss + gl
    grads = torch.autograd.grad(loss, tree_leaves(p), allow_unused=True)
    return (loss.item(), [None if g is None else g.cpu() for g in grads],
            params_to_numpy(new_state))


def check_train_grads(label, cfg, params_np, state_np, seed):
    """Card against CPU: one backward on TRAIN_CHECK_IMAGES images at full
    width.  Returns the new model states (card, CPU)."""
    from subgc_tpu_torch.data.synthetic import synthetic_train_batch
    batch = synthetic_train_batch(cfg, TRAIN_CHECK_IMAGES, seed=seed)
    t0 = time.perf_counter()
    card = _loss_and_grads(cfg, params_np, state_np, batch, "cuda")
    cpu = _loss_and_grads(cfg, params_np, state_np, batch, "cpu")
    compare_grads(label, _leaf_names(params_np), card, cpu, t0)
    return card[2], cpu[2]


def compare_grads(label, names, card, cpu, t0):
    """The float32 rule, card (loss, grads) against CPU: the loss within
    rtol 1e-5, every parameter's gradient within 1e-3 of the CPU's
    relative to its norm (plus 1e-6 of the whole gradient's norm), and
    non-zero on the card wherever it is live on the CPU; the attention's
    leaves must have a gradient on the card."""
    import torch
    if abs(card[0] - cpu[0]) > 1e-5 * abs(cpu[0]):
        fail(f"{label}: loss card {card[0]} cpu {cpu[0]}")
    total = float(torch.sqrt(sum((g.double() ** 2).sum()
                                 for g in cpu[1] if g is not None)))
    worst, worst_name, n_live = 0.0, "", 0
    for name, gc, gg in zip(names, cpu[1], card[1]):
        if gc is None or gg is None:
            if (gc is None) != (gg is None):
                fail(f"{label}: {name} has a gradient on one side only")
            continue
        nc = float(gc.norm())
        err = float((gg - gc).norm())
        if err > 1e-3 * nc + 1e-6 * total:
            fail(f"{label}: {name} gradient card vs cpu |d| {err:.3g}, "
                 f"|cpu| {nc:.3g}")
        if nc > 1e-6 * total:
            n_live += 1
            if float(gg.norm()) == 0.0:
                fail(f"{label}: {name} has a zero gradient on the card")
            if err / nc > worst:
                worst, worst_name = err / nc, name
    for name in ("decoder.h2att.w", "decoder.alpha_net.w",
                 "decoder.ctx2att.w", "decoder.att_embed.w"):
        g = card[1][names.index(name)]
        if g is None or float(g.norm()) == 0.0:
            fail(f"{label}: no gradient reached {name} on the card")
    print(f"{label} card vs cpu ({time.perf_counter() - t0:.1f} s): loss "
          f"{card[0]:.6f} / {cpu[0]:.6f}; {n_live} live parameters of "
          f"{len(names)}, worst relative gradient error {worst:.3g} "
          f"({worst_name})")


def _val_pass(label, cfg, ts, batch_np, expect_row, expect_shared,
              rtol=1e-5):
    """The val pass (no autograd) on the card with the kernel counters reset
    just before it, then on the CPU (plain attention) from the same params:
    checks the launches (of the bf16 variants in the bf16 chain) and the
    card's loss against the CPU's (``rtol``).  Returns (card loss, CPU
    loss, row_attention launches, shared_attention launches), the launches
    as counted."""
    import torch
    from subgc_tpu_torch import params_from_numpy
    from subgc_tpu_torch.models.params import params_to_numpy
    from subgc_tpu_torch.ops import attention as A
    from subgc_tpu_torch.train.step import batch_to_device, make_val_step
    val_step = make_val_step(cfg)
    batch = batch_to_device(batch_np, "cuda")
    torch.cuda.synchronize()
    A.reset_launch_counts()
    reset_gemm()
    loss = val_step(ts.params, ts.model_state, batch)
    torch.cuda.synchronize()
    bf16 = cfg.compute_dtype == "bfloat16"
    # teacher-forced: the word's product is hoisted out of the steps
    check_gemm_launches(label, 0 if bf16 else len(batch_np.labels),
                        cfg.seq_length + 1, per_step=6)
    row, shared = ((A.ROW_BF16_LAUNCHES, A.SHARED_BF16_LAUNCHES) if bf16
                   else (A.ROW_LAUNCHES, A.LAUNCHES))
    if (row, shared) != (expect_row, expect_shared) or (
            A.ROW_LAUNCHES + A.LAUNCHES if bf16 else
            A.ROW_BF16_LAUNCHES + A.SHARED_BF16_LAUNCHES):
        fail(f"{label}: row_attention launched {row} times, shared_attention "
             f"{shared}; expected {expect_row} and {expect_shared}")
    check_project_launches(label, row + shared)
    loss = loss.item()
    t0 = time.perf_counter()
    cpu_loss = val_step(
        *(params_from_numpy(params_to_numpy(t), "cpu")
          for t in (ts.params, ts.model_state)),
        batch_to_device(batch_np, "cpu")).item()
    if not (np.isfinite(loss)
            and abs(loss - cpu_loss) <= rtol * abs(cpu_loss)):
        fail(f"{label}: loss card {loss} cpu {cpu_loss}")
    print(f"{label}: loss card {loss:.6f} cpu {cpu_loss:.6f} "
          f"({time.perf_counter() - t0:.1f} s on cpu) on "
          f"{len(batch_np.img_ix)} sentences; row_attention launches {row}, "
          f"shared_attention {shared}")
    return loss, cpu_loss, row, shared


def check_val_card_cpu(cfg, params_np, state_np, seed):
    """The val loss on TRAIN_CHECK_IMAGES images, card (kernels) against
    CPU (plain versions), within rtol 1e-5."""
    from subgc_tpu_torch import params_from_numpy
    from subgc_tpu_torch.data.synthetic import synthetic_train_batch
    from subgc_tpu_torch.train.step import batch_to_device, make_val_step
    batch = synthetic_train_batch(cfg, TRAIN_CHECK_IMAGES, seed=seed)
    losses = [make_val_step(cfg)(params_from_numpy(params_np, d),
                                 params_from_numpy(state_np, d),
                                 batch_to_device(batch, d)).item()
              for d in ("cuda", "cpu")]
    if abs(losses[0] - losses[1]) > 1e-5 * abs(losses[1]):
        fail(f"val loss card {losses[0]} cpu {losses[1]}")
    return losses


def run_train_steps(label, cfg, tcfg, params_np, state_np, n_hoisted,
                    n_ss, seed):
    """Full-width train steps on the card from ``params_np``: ``n_hoisted``
    hoisted steps, then ``n_ss`` with scheduled sampling at 0.25, dropout
    on, each checked and timed; then one more step of each kind under
    CUDA's sync debug mode set to raise, which must find no host sync (the
    mode adds host overhead, so those steps are not timed).  Returns
    (TrainState, the batch on the host, stats)."""
    import torch
    from subgc_tpu_torch import params_from_numpy
    from subgc_tpu_torch.data.synthetic import synthetic_train_batch
    from subgc_tpu_torch.train.optim import tree_leaves
    from subgc_tpu_torch.train.step import (batch_to_device,
                                            init_train_state,
                                            make_train_step)
    dev = torch.device("cuda")
    ts = init_train_state(params_from_numpy(params_np, dev, True),
                          params_from_numpy(state_np, dev), tcfg,
                          step=tcfg.warmup_n + 1)       # past the LR warmup
    batch_np = synthetic_train_batch(cfg, tcfg.batch_size, seed=seed)
    batch = batch_to_device(batch_np, dev)
    steps = [make_train_step(cfg, tcfg, ss_active=False),
             make_train_step(cfg, tcfg)]
    gen = torch.Generator(device=dev).manual_seed(seed)
    names = _leaf_names(params_np)

    def one_step(i, ss, strict):
        nonlocal ts
        before = [t.detach().clone() for t in tree_leaves(ts.params)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # the sync debug mode is process-wide: the strict step reads a batch
        # copied synchronously before it (no prefetcher thread runs here;
        # phase 24's copies it from pinned memory after every such check)
        torch.cuda.set_sync_debug_mode("error" if strict else 0)
        reset_gemm()
        try:
            ts, m = steps[ss](ts, batch, gen, 0, 0.25 if ss else 0.0)
        except RuntimeError as err:
            fail(f"{label} step {i} synchronized with the host: {err}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        check_gemm_launches(f"{label} step {i}", 0, 0)
        ms = 1e3 * (time.perf_counter() - t0)
        vals = {k: v.item() for k, v in m.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            fail(f"{label} step {i}: {vals}")
        still = [n for n, a, b in zip(names, before, tree_leaves(ts.params))
                 if torch.equal(a, b)]
        if any(n.startswith("decoder.") for n in still):
            fail(f"{label} step {i}: decoder params did not move: {still}")
        print(f"{label} step {i} ({'scheduled sampling' if ss else 'hoisted'})"
              f": loss {vals['loss']:.4f} (lang {vals['lang_loss']:.4f}, "
              f"sGPN {vals['gpn_loss']:.4f}), |g| {vals['grad_norm']:.4f}, "
              f"lr {vals['lr']:.2e}, "
              + ("no host sync" if strict else f"{ms:.2f} ms")
              + f"; {len(names) - len(still)} of {len(names)} params moved")
        return ms

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = [one_step(i, i >= n_hoisted, False)
          for i in range(n_hoisted + n_ss)]
    for ss in ([False, True] if n_ss else [False]):
        one_step(len(ms) + ss, ss, True)
    # the first step of each kind pays its first-use costs
    hoisted_ms = statistics.median(ms[1:n_hoisted])
    stats = {"images": tcfg.batch_size, "ms_per_step": hoisted_ms,
             "images_per_s": tcfg.batch_size * 1e3 / hoisted_ms,
             "ss_ms_per_step": ms[-1] if n_ss > 1 else None,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"{label}: {stats['ms_per_step']:.2f} ms per hoisted step = "
          f"{stats['images_per_s']:.1f} images/s ({tcfg.batch_size} images, "
          f"{5 * tcfg.batch_size} sentences); last scheduled-sampling step "
          f"{stats['ss_ms_per_step']} ms; peak memory "
          f"{stats['peak_mem_gb']:.2f} GiB (with the parameter snapshot "
          f"of the move check)")
    return ts, batch_np, stats


def run_train(params_np, state_np):
    """Phases 14-16.  Returns (row_attention launches, shared_attention
    launches, the stats printed)."""
    from subgc_tpu_torch import build_configs
    from subgc_tpu_torch.models.params import init_params_numpy
    cfg, tcfg, _ = build_configs("Sub_GC_Kar", mode="train")
    # ---- 14. Sub_GC_Kar training
    ts, batch_np, kar = run_train_steps("Sub_GC_Kar train", cfg, tcfg,
                                        params_np, state_np, 3, 2, seed=0)
    check_train_grads("Sub_GC_Kar gradients", cfg, params_np, state_np,
                      seed=1)
    _, _, row, _ = _val_pass("Sub_GC_Kar val pass", cfg, ts, batch_np,
                             cfg.seq_length + 1, 0)
    vl = check_val_card_cpu(cfg, params_np, state_np, seed=2)
    print(f"Sub_GC_Kar val loss on {TRAIN_CHECK_IMAGES} images: card "
          f"{vl[0]:.6f} cpu {vl[1]:.6f}")
    # ---- 15. share_att_train
    shared_cfg = cfg.replace(share_att_train=True)
    check_train_grads("share_att_train gradients", shared_cfg, params_np,
                      state_np, seed=3)
    _, _, _, shared = _val_pass("share_att_train val pass", shared_cfg, ts,
                                batch_np, 0, cfg.seq_length + 1)
    # Sub_GC_Kar's TrainState leaves the card before Full_GC_Kar's peak
    # memory is read
    del ts
    # ---- 16. Full_GC_Kar training
    fcfg, ftcfg, _ = build_configs("Full_GC_Kar", mode="train")
    fp, fs = init_params_numpy(fcfg, seed=0)
    fts, _, full = run_train_steps("Full_GC_Kar train", fcfg, ftcfg, fp, fs,
                                   2, 0, seed=4)
    for layer, init in zip(fts.model_state["gcn_bn"], fs["gcn_bn"]):
        for u, u0 in zip(layer, init):
            for k in ("mean", "var"):
                v = u[k].cpu().numpy()
                if not np.isfinite(v).all() or np.array_equal(v, u0[k]):
                    fail(f"Full_GC_Kar: GCN BatchNorm {k} did not move or "
                         f"is not finite")
    card_state, cpu_state = check_train_grads("Full_GC_Kar gradients", fcfg,
                                              fp, fs, seed=5)
    err = max(float(np.abs(a[k] - b[k]).max())
              for la, lb in zip(card_state["gcn_bn"], cpu_state["gcn_bn"])
              for a, b in zip(la, lb) for k in ("mean", "var"))
    if err > 1e-5:
        fail(f"Full_GC_Kar: new BatchNorm state card vs cpu |d| {err:.3g}")
    print(f"Full_GC_Kar: GCN running statistics moved and finite; new state "
          f"card vs cpu max |d| {err:.3g}")
    return row, shared, {"Sub_GC_Kar": kar, "Full_GC_Kar": full}


# ---- the bfloat16 chain (phases 17-20)

BF16_MODEL = dict(compute_dtype="bfloat16", bf16_lstm_gates=True)


def run_bf16_kernels(params, S_main, S_val, card):
    """Phase 17: both bf16 variants against their plain versions on the
    card at the main paths' shapes: Sub_GC_Kar's (S_main rows) in both
    beam layouts, the M-RNN fan-out, Full_GC_Kar's one row of 3 beams, the
    grounding path's rows and the val pass's (S_val); each entry's two
    stages timed apart; the bf16 projection alone at those paths' query
    counts beside ``torch.addmm`` in bf16.  Returns (shared checks, row
    checks, projection checks), the main path's shape first."""
    print(f"bf16 kernels on {card}:")
    shared = [check_attention(params, "image", S_main, BATCH_IMAGES,
                              seed=50, bf16=True),
              check_attention(params, "subgraph", S_main, S_main, seed=51,
                              bf16=True),
              check_attention(params, "image", 2000, 2, seed=52, beams=1,
                              bf16=True),
              check_attention(params, "subgraph", 1, 1, seed=53, beams=3,
                              bf16=True)]
    row = [check_row_attention(params, S_main, seed=54, bf16=True),
           check_row_attention(params, S_val, seed=55, bf16=True)]
    for c in shared + row:
        print(f"  bf16 bound {c['bound_ms']:.4f} ms ({c['bound_by']}); "
              f"with its operations at the float32 peak "
              f"{c['bound_f32_peak_ms']:.4f} ms; stages (CUDA events): "
              f"projection alone {c['project_ms']:.4f} ms, attention "
              f"(entry less it) {c['attend_ms']:.4f} ms; (profiler): "
              + ("not measured, the trace held no kernel of a stage"
                 if c["project_prof_ms"] is None else
                 f"projection {c['project_prof_ms']:.4f} ms, attention "
                 f"{c['attend_prof_ms']:.4f} ms"))
    qs = (2 * S_main, 2000, S_main, 3)
    projections = [check_projection(params, Q, seed=56 + i, bf16=True)
                   for i, Q in enumerate(qs)]
    print(json.dumps({"projection_stage_bf16": [
        {"Q": Q, **p} for Q, p in zip(qs, projections)], "card": card}))
    return shared, row, projections


def bf16_decode_step_err(params, cpu_params, state, examples, cfg, ecfg):
    """One full-width ``decode_step`` in the image-shared beam layout, card
    against CPU, from the same features (the CPU's encoding, copied to the
    card), the same seeded state and tokens: max |logprob difference|."""
    import torch
    from subgc_tpu_torch.eval.runner import _stack_examples
    from subgc_tpu_torch.graph import to_device
    from subgc_tpu_torch.models import decoder as D
    from subgc_tpu_torch.models.subgc import encode_images_batched
    graph, subs = (to_device(x, "cpu") for x in _stack_examples(examples))
    with torch.no_grad():
        feats = encode_images_batched(cpu_params, state, graph, subs, cfg,
                                      ecfg).feats
        S, B, R = feats.fc.shape[0], ecfg.beam_size, cfg.rnn_size
        g = torch.Generator().manual_seed(60)
        h = (torch.rand((S, B, R), generator=g) * 2 - 1).to(torch.bfloat16)
        c = torch.randn((S, B, R), generator=g)
        state0 = D.DecoderState(h, c, h, c)
        token = torch.randint(1, cfg.vocab_size, (S, B), generator=g)
        out = []
        for p in (cpu_params, params):
            dev = p["decoder"]["logit"]["w"].device
            f = D.PreparedFeatures(*(None if t is None else t.to(dev)
                                     for t in feats))
            lp, _, _ = D.decode_step(
                D.cast_decoder_weights(p, cfg),
                D.DecoderState(*(t.to(dev) for t in state0)),
                token.to(dev), f, cfg)
            out.append(lp.cpu())
    return (out[0] - out[1]).abs().max().item()


def caption_agreement(a_preds, b_preds):
    """(identical, compared) captions over the sub-graphs both kept."""
    same = total = 0
    for a, b in zip(a_preds, b_preds):
        ca = dict(zip(np.asarray(a["sorted_subgraph_ind"]).tolist(),
                      a["caption"]))
        cb = dict(zip(np.asarray(b["sorted_subgraph_ind"]).tolist(),
                      b["caption"]))
        for k in set(ca) & set(cb):
            total += 1
            same += ca[k] == cb[k]
    return same, total


def run_bf16_test(params, cpu_params, state, examples, vocab, f32_preds):
    """Phase 18: Sub_GC_Kar in bf16 + bf16 gates at full width, the
    configuration bench.py decodes, on phase 4's images; card against CPU on
    the first batch.  Returns (bf16 shared kernel launches, stats)."""
    import torch
    from subgc_tpu_torch import build_configs, run_test_split
    from subgc_tpu_torch.ops import attention as A
    cfg, ecfg, _ = build_configs("Sub_GC_Kar", model=BF16_MODEL,
                                 eval=dict(max_subgraph_bucket=BUCKET))
    loader = MemoryLoader(examples)
    run_test_split(params, state, loader, cfg, ecfg, vocab,
                   num_images=BATCH_IMAGES, verbose=False,
                   batch_images=BATCH_IMAGES, device="cuda")    # warm-up
    torch.cuda.synchronize()
    A.reset_launch_counts()
    reset_gemm()
    preds, wall, n_caps = run_test_split(
        params, state, loader, cfg, ecfg, vocab, verbose=False,
        batch_images=BATCH_IMAGES, device="cuda")
    check_gemm_launches("bf16 main path", 0, 0)
    launches = A.SHARED_BF16_LAUNCHES
    n_dispatch = -(-len(examples) // BATCH_IMAGES)
    others = A.LAUNCHES + A.ROW_LAUNCHES + A.ROW_BF16_LAUNCHES
    if launches != n_dispatch * cfg.seq_length or others:
        fail(f"bf16 main path: shared bf16 kernel launched {launches} times "
             f"and the others {others}; expected {n_dispatch} dispatches x "
             f"{cfg.seq_length} steps and 0")
    check_project_launches("bf16 main path", launches)
    check_predictions(preds, len(examples), ecfg.gpn_max_subg)
    enc_ms, dec_ms = phase_times(params, state, examples[:BATCH_IMAGES], cfg,
                                 ecfg, torch.device("cuda"))
    print(f"bf16 main path (Sub_GC_Kar, bf16 + bf16 gates): {len(examples)} "
          f"images, {n_caps} captions in {wall:.3f} s = {n_caps / wall:.1f} "
          f"captions/s; per {BATCH_IMAGES}-image batch: encoder+sGPN+NMS "
          f"{enc_ms:.2f} ms, beam decode {dec_ms:.2f} ms; shared bf16 kernel "
          f"launches {launches}")

    t0 = time.perf_counter()
    cpu_preds, _, _ = run_test_split(
        cpu_params, state, loader, cfg, ecfg, vocab, num_images=BATCH_IMAGES,
        verbose=False, batch_images=BATCH_IMAGES, device="cpu")
    cpu_s = time.perf_counter() - t0
    n_keep, worst = 0, 0.0
    for g, c in zip(preds, cpu_preds):
        gs = dict(zip(np.asarray(g["sorted_subgraph_ind"]).tolist(),
                      g["subgraph_score"]))
        cs = dict(zip(np.asarray(c["sorted_subgraph_ind"]).tolist(),
                      c["subgraph_score"]))
        n_keep += sorted(gs) == sorted(cs)
        worst = max([worst] + [float(abs(gs[k] - cs[k]))
                               for k in set(gs) & set(cs)])
    if worst > 2e-2:
        fail(f"bf16: sGPN scores card vs cpu differ by {worst:.3g} > 2e-2")
    if n_keep < 0.9 * len(cpu_preds):
        fail(f"bf16: keep sets identical on only {n_keep}/{len(cpu_preds)} "
             f"images")
    step_err = bf16_decode_step_err(params, cpu_params, state,
                                    examples[:BATCH_IMAGES], cfg, ecfg)
    if not step_err <= 5e-2:
        fail(f"bf16: one decode_step's logprobs card vs cpu differ by "
             f"{step_err:.3g} > 5e-2")
    vs_cpu = caption_agreement(preds, cpu_preds)
    vs_f32 = caption_agreement(preds, f32_preds)
    print(f"bf16 card vs cpu ({cpu_s:.1f} s on cpu): keep sets identical on "
          f"{n_keep}/{len(cpu_preds)} images, sGPN scores within "
          f"{worst:.3g}, one decode_step's logprobs within {step_err:.3g}; "
          f"captions identical: {vs_cpu[0]}/{vs_cpu[1]} against the cpu's "
          f"bf16, {vs_f32[0]}/{vs_f32[1]} against the card's float32")
    return launches, {"images": len(examples), "captions": n_caps,
                      "captions_per_s": n_caps / wall, "encode_ms": enc_ms,
                      "decode_ms": dec_ms, "keep_sets_identical": n_keep,
                      "score_max_diff": worst, "decode_step_max_diff":
                      step_err, "captions_vs_cpu_bf16": vs_cpu,
                      "captions_vs_card_f32": vs_f32}


def run_bf16_grounding(params, cpu_params, state, examples, vocab):
    """Phase 19: Sub_GC_Flickr_GRD in bf16 + bf16 gates with a collector,
    the per-row bf16 kernel; card against CPU on the first batch, printed.
    Returns the row bf16 kernel's launches."""
    import torch
    from subgc_tpu_torch import (GroundingCollector, build_configs,
                                 run_test_split)
    from subgc_tpu_torch.ops import attention as A
    cfg, ecfg, _ = build_configs("Sub_GC_Flickr_GRD", model=BF16_MODEL,
                                 eval=dict(max_subgraph_bucket=BUCKET))
    loader = MemoryLoader(examples)
    tables = grounding_tables(vocab, examples)
    run_test_split(params, state, loader, cfg, ecfg, vocab,
                   num_images=BATCH_IMAGES, verbose=False,
                   batch_images=BATCH_IMAGES, device="cuda")    # warm-up
    torch.cuda.synchronize()
    col = GroundingCollector(*tables)
    A.reset_launch_counts()
    reset_gemm()
    preds, wall, n_caps = run_test_split(
        params, state, loader, cfg, ecfg, vocab, verbose=False,
        batch_images=BATCH_IMAGES, device="cuda", collect_grounding=col)
    check_gemm_launches("bf16 grounding path", 0, 0)
    launches = A.ROW_BF16_LAUNCHES
    others = A.LAUNCHES + A.ROW_LAUNCHES + A.SHARED_BF16_LAUNCHES
    n_dispatch = -(-len(examples) // BATCH_IMAGES)
    if launches != n_dispatch * (cfg.seq_length + 1) or others:
        fail(f"bf16 grounding path: row bf16 kernel launched {launches} "
             f"times and the others {others}; expected {n_dispatch} "
             f"dispatches x {cfg.seq_length + 1} steps and 0")
    check_project_launches("bf16 grounding path", launches)
    check_predictions(preds, len(examples), ecfg.gpn_max_subg)
    if sorted(col.output) != sorted(str(ex.info.id) for ex in examples):
        fail("bf16 grounding path: the collector missed images")
    cpu_col = GroundingCollector(*tables)
    cpu_preds, _, _ = run_test_split(
        cpu_params, state, loader, cfg, ecfg, vocab, num_images=BATCH_IMAGES,
        verbose=False, batch_images=BATCH_IMAGES, device="cpu",
        collect_grounding=cpu_col)
    same = caption_agreement(preds, cpu_preds)
    same_best = [str(g["image_id"]) for g, c in zip(preds, cpu_preds)
                 if g["caption"][0] == c["caption"][0]]
    n_grd = sum(col.output[i] == cpu_col.output[i] for i in same_best)
    print(f"bf16 grounding path (Sub_GC_Flickr_GRD, bf16 + bf16 gates): "
          f"{len(examples)} images, {n_caps} captions in {wall:.3f} s = "
          f"{n_caps / wall:.1f} captions/s; row bf16 kernel launches "
          f"{launches}; card vs cpu: {same[0]}/{same[1]} captions "
          f"identical, grounding entries identical for {n_grd}/"
          f"{len(same_best)} images with the same best caption")
    return launches


def run_bf16_train(params_np, state_np):
    """Phase 20: Sub_GC_Kar training in bf16 + bf16 gates + bf16 residuals
    (bench.py's train step) at the preset's batch.  Returns (row bf16
    kernel launches of its val pass, stats)."""
    import torch
    from subgc_tpu_torch import build_configs
    from subgc_tpu_torch.train.step import batch_to_device, make_val_step
    cfg, tcfg, _ = build_configs("Sub_GC_Kar", mode="train", model=dict(
        BF16_MODEL, bf16_residuals=True))
    ts, batch_np, stats = run_train_steps("Sub_GC_Kar bf16 train", cfg, tcfg,
                                          params_np, state_np, 3, 0, seed=0)
    check_train_grads_bf16(cfg, params_np, state_np, seed=1)
    loss, cpu_loss, row, _ = _val_pass("Sub_GC_Kar bf16 val pass", cfg, ts,
                                       batch_np, cfg.seq_length + 1, 0,
                                       rtol=1e-3)
    f32_loss = make_val_step(cfg.replace(
        compute_dtype="float32", bf16_lstm_gates=False, bf16_residuals=False))(
        ts.params, ts.model_state, batch_to_device(batch_np, "cuda")).item()
    if abs(loss - f32_loss) > 1e-2 * abs(f32_loss):
        fail(f"bf16 val loss {loss} against float32 {f32_loss}")
    print(f"Sub_GC_Kar bf16 val loss {loss:.6f}: cpu {cpu_loss:.6f}, card "
          f"float32 {f32_loss:.6f}")
    del ts
    torch.cuda.empty_cache()
    return row, {**stats, "val_loss": loss, "val_loss_cpu": cpu_loss,
                 "val_loss_f32": f32_loss}


def check_train_grads_bf16(cfg, params_np, state_np, seed):
    """Card against CPU in the bf16 chain: one backward on
    TRAIN_CHECK_IMAGES images at full width (``compare_grads_bf16``)."""
    from subgc_tpu_torch.data.synthetic import synthetic_train_batch
    batch = synthetic_train_batch(cfg, TRAIN_CHECK_IMAGES, seed=seed)
    t0 = time.perf_counter()
    card = _loss_and_grads(cfg, params_np, state_np, batch, "cuda")
    cpu = _loss_and_grads(cfg, params_np, state_np, batch, "cpu")
    compare_grads_bf16("Sub_GC_Kar bf16 gradients", _leaf_names(params_np),
                       card, cpu, t0)


def compare_grads_bf16(label, names, card, cpu, t0):
    """The bf16 rule, card (loss, grads) against CPU: the loss within rtol
    1e-3.  Every live gradient (norm above 1e-6 of the whole gradient's
    on the CPU) is non-zero on the card; those that hold >= 1e-3 of the
    whole norm have cosine >= 0.99 against the CPU's.  The smaller live
    ones are the attention's score leaves (``ctx2att.b``, ``h2att``: ~5e-5
    of the norm), sums over every node and sentence that the softmax's
    shift invariance cancels to ~1e-4 of their terms, so bf16 rounding in
    either backward decides their direction (cosine 0.968 measured on an
    H100); each is held within 1e-4 of the whole gradient's norm
    instead."""
    import torch
    if abs(card[0] - cpu[0]) > 1e-3 * abs(cpu[0]):
        fail(f"{label}: loss card {card[0]} cpu {cpu[0]}")
    total = float(torch.sqrt(sum((g.double() ** 2).sum()
                                 for g in cpu[1] if g is not None)))
    worst, worst_name, n_live, small = 1.0, "", 0, {}
    for name, gc, gg in zip(names, cpu[1], card[1]):
        if gc is None or gg is None:
            if (gc is None) != (gg is None):
                fail(f"{label}: {name} has a gradient on one side only")
            continue
        nc, ng = float(gc.norm()), float(gg.norm())
        if nc <= 1e-6 * total:
            continue
        n_live += 1
        if ng == 0.0:
            fail(f"{label}: {name} has a zero gradient on the card")
        if nc < 1e-3 * total:
            small[name] = float((gg - gc).norm()) / total
            if small[name] > 1e-4:
                fail(f"{label}: {name} card vs cpu |d| {small[name]:.3g} "
                     f"of the whole gradient's norm")
            continue
        cos = float((gc.double() * gg.double()).sum()) / (nc * ng)
        if cos < 0.99:
            fail(f"{label}: {name} cosine {cos:.4f} card vs cpu")
        if cos < worst:
            worst, worst_name = cos, name
    print(f"{label} card vs cpu ({time.perf_counter() - t0:.1f} s): loss "
          f"{card[0]:.6f} / {cpu[0]:.6f}; {n_live} live parameters of "
          f"{len(names)}, none lost, lowest cosine {worst:.5f} "
          f"({worst_name}); below 1e-3 of the norm, |d| / |whole "
          f"gradient|: " + ", ".join(f"{k} {v:.3g}"
                                      for k, v in small.items()))


SCST_CHECK_IMAGES = 16    # SCST greedy tokens, card against CPU
SERVE_BATCH = 8           # images a serving dispatch decodes
SERVE_IMAGES = 32         # the concurrent burst; phase 4's first images
SERVE_CLIENTS = (1, 8, 32)
SERVE_REQUESTS = 32       # requests per concurrency level


def request_image(ex):
    """A phase 4 test example as a ``/caption`` request image: its real
    nodes and relations (not the dummy ones) and its sub-graphs' nodes."""
    g, s = ex.graph, ex.subs
    return {"id": int(ex.info.id),
            "object_fmap": g.obj_fmap[0, :-1].tolist(),
            "object_dist": g.obj_dist[0, :-1].tolist(),
            "rel_ind": g.rel_ind[0, :-1].tolist(),
            "pred_dist": g.pred_dist[0, :-1].tolist(),
            "subgraphs": [{"nodes": s.obj_ind[i][s.att_mask[i] > 0].tolist(),
                           "rels": []} for i in range(len(s.valid))
                          if s.valid[i]]}


def serve_dtype_cfg(cfg, dtype):
    """The model config a ModelService decodes ``dtype`` with."""
    return cfg.replace(compute_dtype=dtype,
                       bf16_lstm_gates=dtype == "bfloat16",
                       share_att_images=dtype == "bfloat16")


def direct_answers(params, state, cfg, ecfg, vocab, imgs, dtype, device):
    """Each image decoded alone by ``make_batched_infer_fn`` at the serving
    padding (the image repeated to SERVE_BATCH), with its graph and
    sub-graphs built here from the request's arrays (or, without
    sub-graphs, the bank the server samples).  Returns a prediction per
    image in the server's order (sGPN score, descending)."""
    import torch
    from subgc_tpu_torch import decode_sequence, make_batched_infer_fn
    from subgc_tpu_torch.data.subgraph_sampler import sample_subgraph_bank
    from subgc_tpu_torch.graph import (SceneGraph, SubgraphSet,
                                       make_scene_graph, pad_subgraph_set,
                                       subgraphs_from_masks, to_device)
    mcfg = serve_dtype_cfg(cfg, dtype)
    infer = make_batched_infer_fn(mcfg, ecfg)
    bucket = ecfg.max_subgraph_bucket
    N, K = mcfg.obj_num, mcfg.rel_num
    out = []
    for img in imgs:
        a = {k: np.asarray(img[k], np.int64 if k == "rel_ind" else "f")
             for k in ("object_fmap", "object_dist", "rel_ind",
                       "pred_dist")}
        graph = make_scene_graph(a["object_fmap"], a["object_dist"],
                                 a["rel_ind"], a["pred_dist"], N, K)
        if "subgraphs" in img:
            om = np.zeros((len(img["subgraphs"]), N - 1))
            for i, sg in enumerate(img["subgraphs"]):
                om[i, sg["nodes"]] = 1
            pm = np.zeros((len(om), K - 1))
        else:
            n = len(a["object_fmap"])
            masks = sample_subgraph_bank(
                n, a["rel_ind"], [np.arange(min(2, n))] * 5,
                n_samples=min(bucket - 5, 64))["subgraph_mask_list"][5:]
            om = np.stack([m[1][:N - 1] for m in masks])
            pm = np.stack([m[2][:K - 1] for m in masks])
        subs = pad_subgraph_set(subgraphs_from_masks(om, pm, N, K), bucket)
        graph = SceneGraph(*[np.concatenate([x] * SERVE_BATCH)
                             for x in graph])
        subs = SubgraphSet(*[np.stack([x] * SERVE_BATCH) for x in subs])
        r = infer(params, state, to_device(graph, device),
                  to_device(subs, device))
        r = {k: v[0].cpu().numpy() for k, v in r.items()}
        n = int(r["keep_valid"].sum())
        order = np.argsort(-r["scores"][:n], kind="stable")
        out.append({"image_id": img["id"],
                    "caption": decode_sequence(vocab, r["seq"][:n][order]),
                    "subgraph_score": r["scores"][:n][order],
                    "sorted_subgraph_ind": r["keep_ind"][:n][order]})
    torch.cuda.synchronize()
    return out


def same_answer(served, ref):
    return (served["captions"] == ref["caption"]
            and served["scores"] == ref["subgraph_score"].tolist())


def post(url, body, timeout=300):
    """(status, headers, body bytes) of a POST of ``body`` (bytes)."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, body,
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.getcode(), resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def fire(url, bodies, clients):
    """``clients`` threads post ``bodies`` (each body once, round-robin
    over the threads, all starting together); returns (wall seconds, each
    request's (status, seconds, result body))."""
    import threading
    out = [None] * len(bodies)
    barrier = threading.Barrier(clients)

    def client(c):
        barrier.wait(timeout=60)
        for i in range(c, len(bodies), clients):
            t0 = time.perf_counter()
            status, _, body = post(url, bodies[i])
            out[i] = (status, time.perf_counter() - t0, body)

    ts = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    if any(t.is_alive() for t in ts) or any(o is None for o in out):
        fail("serving: a client did not finish")
    return time.perf_counter() - t0, out


def percentile(xs, q):
    s = sorted(xs)
    return s[min(len(s) - 1, int(len(s) * q))]


def run_serving(params_np, state_np, examples, vocab):
    """Phase 21: serving Sub_GC_Kar over HTTP on the card.  Returns
    (shared_attention launches of the float32 burst, shared bf16 launches
    of the bf16 burst, stats)."""
    import argparse
    import tempfile
    import threading
    import torch
    from subgc_tpu_torch import (build_configs, config_to_json,
                                 decode_sequence, params_from_numpy)
    from subgc_tpu_torch.cli import serve as SV
    from subgc_tpu_torch.train.checkpoint import save_checkpoint
    cfg, ecfg, _ = build_configs("Sub_GC_Kar",
                                 eval=dict(max_subgraph_bucket=BUCKET))
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    save_checkpoint(ckpt, params_np, state_np, None,
                    {"iter": 0, "model_type": "Sub_GC_Kar",
                     "model_config": config_to_json(cfg), "vocab": vocab},
                    {})
    t0 = time.perf_counter()
    registry = SV.load_registry(argparse.Namespace(
        model_type="Sub_GC_Kar", checkpoint_path=[f"kar={ckpt}"],
        bucket=BUCKET, batch_images=SERVE_BATCH, beam_size=None,
        microbatch_wait_ms=3.0, adaptive_wait=False,
        compute_dtype="bfloat16", replicas=1, shard_fanout=1,
        max_queue=256, device="cuda"))
    svc = registry.models["kar"]
    svc.warmup()
    torch.cuda.synchronize()
    print(f"serving: checkpoint loaded and warmed up in "
          f"{time.perf_counter() - t0:.2f} s (default dtype "
          f"{svc.default_dtype}, bucket {BUCKET}, batch {SERVE_BATCH})")
    httpd = SV.serve(registry, port=0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    stats = {}
    try:
        imgs = [request_image(ex) for ex in examples[:SERVE_IMAGES]]
        params = params_from_numpy(params_np, "cuda")
        state = params_from_numpy(state_np, "cuda")
        launches = {}
        for dtype in ("float32", "bfloat16"):
            launches[dtype], stats[dtype] = serve_dtype(
                url, svc, params, state, cfg, ecfg, vocab, imgs, dtype)
        # (c) the float32 server against build_service on the CPU
        t0 = time.perf_counter()
        cpu_handle = SV.build_service(params_np, state_np,
                                      serve_dtype_cfg(cfg, "float32"), ecfg,
                                      vocab, batch_images=SERVE_BATCH,
                                      device="cpu")
        cpu_out = cpu_handle.batcher.submit_many(
            [cpu_handle.to_example(im) for im in imgs[:SERVE_BATCH]])
        cpu_preds = []
        for img, o in zip(imgs, cpu_out):
            n = int(o["keep_valid"].sum())
            order = np.argsort(-o["scores"][:n], kind="stable")
            cpu_preds.append({
                "image_id": img["id"],
                "caption": decode_sequence(vocab, o["seq"][:n][order]),
                "subgraph_score": o["scores"][:n][order],
                "sorted_subgraph_ind": o["keep_ind"][:n][order]})
        n_same, n_total = compare_card_cpu(
            stats["float32"].pop("refs")[:SERVE_BATCH], cpu_preds)
        stats["bfloat16"].pop("refs")
        if n_same < 0.95 * n_total:
            fail(f"serving float32: only {n_same}/{n_total} captions agree "
                 f"between card and cpu")
        print(f"serving float32 card vs cpu build_service "
              f"({time.perf_counter() - t0:.1f} s on cpu): {n_same}/"
              f"{n_total} captions identical, keep sets identical")
        stats["float32"]["card_vs_cpu"] = [n_same, n_total]
        stats["shed"] = check_shedding(params, state, cfg, ecfg, vocab)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=60)
    return launches["float32"], launches["bfloat16"], stats


def serve_dtype(url, svc, params, state, cfg, ecfg, vocab, imgs, dtype):
    """Phase 21 (a), (b), (d), (e) and the timings for one dtype.  Returns
    (the burst's launches of the dtype's kernel, stats)."""
    import torch
    from subgc_tpu_torch.ops import attention as A
    refs = direct_answers(params, state, cfg, ecfg, vocab, imgs, dtype,
                          "cuda")
    t0 = time.perf_counter()
    bodies = [json.dumps({"images": [im], "dtype": dtype}).encode()
              for im in imgs]
    encode_s = time.perf_counter() - t0
    # (a) single requests, one after another
    for img, body, ref in zip(imgs[:8], bodies, refs):
        status, _, out = post(url + "/caption", body)
        res = json.loads(out)["results"][0] if status == 200 else out
        if status != 200 or not same_answer(res, ref):
            fail(f"serving {dtype}: image {img['id']} alone differs from "
                 f"make_batched_infer_fn on it ({status})")
    handle = svc._handle(dtype)
    # (b) 32 concurrent clients, one image each
    torch.cuda.synchronize()
    d0 = handle.batcher.dispatch_count
    A.reset_launch_counts()
    reset_gemm()
    _, res = fire(url + "/caption", bodies, len(bodies))
    torch.cuda.synchronize()
    dispatches = handle.batcher.dispatch_count - d0
    check_gemm_launches(f"serving {dtype}", 0 if dtype == "bfloat16" else
                        serving_rows([len(r["caption"]) for r in refs],
                                     ecfg.beam_size),
                        dispatches * cfg.seq_length, calls=dispatches)
    counts = {n: getattr(A, n) for n in (
        "LAUNCHES", "ROW_LAUNCHES", "SHARED_BF16_LAUNCHES",
        "ROW_BF16_LAUNCHES", "PROJECT_LAUNCHES")}
    for (status, _, out), img, ref in zip(res, imgs, refs):
        if status != 200 or not same_answer(
                json.loads(out)["results"][0], ref):
            fail(f"serving {dtype}: image {img['id']} coalesced differs "
                 f"from its answer alone ({status})")
    if not dispatches < len(bodies):
        fail(f"serving {dtype}: {len(bodies)} concurrent requests took "
             f"{dispatches} dispatches (no coalescing)")
    kernel = "LAUNCHES" if dtype == "float32" else "SHARED_BF16_LAUNCHES"
    want = {n: 0 for n in counts}
    want[kernel] = want["PROJECT_LAUNCHES"] = dispatches * cfg.seq_length
    if counts != want:
        fail(f"serving {dtype}: launches {counts}, expected {want} "
             f"({dispatches} dispatches x {cfg.seq_length} steps)")
    print(f"serving {dtype}: {len(bodies)} concurrent single-image "
          f"requests in {dispatches} dispatches, each answer equal to "
          f"make_batched_infer_fn on its image alone; {kernel} "
          f"{counts[kernel]} launches")
    # (d) a request without sub-graphs: the sampled bank
    bare = {k: v for k, v in imgs[0].items() if k != "subgraphs"}
    ref = direct_answers(params, state, cfg, ecfg, vocab, [bare], dtype,
                         "cuda")[0]
    status, _, out = post(url + "/caption", json.dumps(
        {"images": [bare], "dtype": dtype}).encode())
    if status != 200 or not same_answer(json.loads(out)["results"][0], ref):
        fail(f"serving {dtype}: the sampled-bank answer differs ({status})")
    # (e) a stream of 16 images in chunks of 4
    status, headers, out = post(url + "/caption_stream", json.dumps(
        {"images": imgs[:16], "dtype": dtype, "chunk": 4}).encode())
    lines = [json.loads(x) for x in out.splitlines()]
    if (status != 200 or headers["Content-Type"] != "application/x-ndjson"
            or lines[-1] != {"done": True, "count": 16}
            or not all(same_answer(r, ref)
                       for r, ref in zip(lines[:-1], refs[:16]))
            or len(lines) != 17):
        fail(f"serving {dtype}: /caption_stream gave {status}, "
             f"{len(lines)} lines, trailer {lines[-1] if lines else None}")
    # host cost of a request, apart from the dispatch
    t0 = time.perf_counter()
    decoded = [json.loads(b)["images"][0] for b in bodies[:8]]
    t1 = time.perf_counter()
    for img in decoded:
        handle.to_example(img)
    t2 = time.perf_counter()
    st = {"bytes_per_image": sum(map(len, bodies)) / len(bodies),
          "client_json_encode_ms_per_image": 1e3 * encode_s / len(bodies),
          "json_decode_ms_per_image": 1e3 * (t1 - t0) / 8,
          "to_example_ms_per_image": 1e3 * (t2 - t1) / 8,
          "burst_dispatches": dispatches, "levels": {}}
    # images/s and latency at 1, 8 and 32 concurrent clients
    for clients in SERVE_CLIENTS:
        handle.latency.reset()
        d0, i0 = handle.batcher.dispatch_count, handle.batcher.item_count
        wall, res = fire(url + "/caption",
                         [bodies[i % len(bodies)]
                          for i in range(SERVE_REQUESTS)], clients)
        if any(r[0] != 200 for r in res):
            fail(f"serving {dtype}: a request failed at {clients} clients")
        lat = [r[1] for r in res]
        dispatches = handle.batcher.dispatch_count - d0
        srv = svc.stats()[dtype]["latency_ms"]
        lv = {"images_per_s": SERVE_REQUESTS / wall,
              "client_p50_ms": 1e3 * percentile(lat, 0.5),
              "client_p90_ms": 1e3 * percentile(lat, 0.9),
              "server_p50_ms": srv["p50"], "server_p90_ms": srv["p90"],
              "dispatches": dispatches,
              "mean_fill": (handle.batcher.item_count - i0) / dispatches}
        st["levels"][clients] = lv
        print(f"serving {dtype}, {clients:2d} clients: "
              f"{lv['images_per_s']:.1f} images/s; latency p50 / p90 client "
              f"{lv['client_p50_ms']:.1f} / {lv['client_p90_ms']:.1f} ms, "
              f"server {lv['server_p50_ms']:.1f} / {lv['server_p90_ms']:.1f}"
              f" ms; {dispatches} dispatches, mean fill "
              f"{lv['mean_fill']:.2f} of {SERVE_BATCH}")
    print(f"serving {dtype}: {st['bytes_per_image'] / 2 ** 20:.2f} MiB of "
          f"JSON per image; host ms per image: json.loads "
          f"{st['json_decode_ms_per_image']:.2f}, to_example "
          f"{st['to_example_ms_per_image']:.2f} (client json.dumps "
          f"{st['client_json_encode_ms_per_image']:.2f})")
    st["refs"] = refs
    return counts[kernel], st


def check_shedding(params, state, cfg, ecfg, vocab):
    """Phase 21 (f): a 12-request burst against max_queue 2 at one image
    a dispatch (each dispatch held 0.25 s longer, so that the burst must
    overflow): only 200 and 429, both present, each 429 with Retry-After,
    the shed count equal to the 429s."""
    import threading
    from subgc_tpu_torch.cli import serve as SV
    handle = SV.build_service(params, state,
                              serve_dtype_cfg(cfg, "bfloat16"), ecfg, vocab,
                              batch_images=1, max_queue=2, device="cuda")
    run = handle.batcher._run
    handle.batcher._run = lambda xs: (time.sleep(0.25), run(xs))[1]
    rng = np.random.RandomState(70)
    n, k = 4, 3
    body = json.dumps({"images": [{
        "object_fmap": rng.rand(n, cfg.att_feat_size).tolist(),
        "object_dist": rng.rand(n, cfg.num_obj_classes).tolist(),
        "rel_ind": rng.randint(0, n, (k, 2)).tolist(),
        "pred_dist": rng.rand(k, cfg.num_rel_classes).tolist(),
        "subgraphs": [{"nodes": [0, 1], "rels": [0]}]}]}).encode()
    httpd = SV.serve(handle, port=0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        if post(url + "/caption", body)[0] != 200:
            fail("serving (f): the warm-up request failed")
        codes, retry = [], []
        lock = threading.Lock()

        def one(endpoint):
            status, headers, _ = post(url + endpoint, body)
            with lock:
                codes.append(status)
                if status == 429:
                    retry.append(headers.get("Retry-After"))

        ts = [threading.Thread(target=one, args=(ep,))
              for ep in ["/caption"] * 8 + ["/caption_stream"] * 4]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=60)
    if (len(codes) != 12 or set(codes) != {200, 429}
            or len(retry) != codes.count(429)
            or not all(r == "1" for r in retry)
            or handle.batcher.shed_count != codes.count(429)):
        fail(f"serving (f): burst codes {sorted(codes)}, Retry-After "
             f"{retry}, shed count {handle.batcher.shed_count}")
    print(f"serving (f): 12-request burst at max_queue 2: "
          f"{codes.count(200)} served, {codes.count(429)} shed with 429 + "
          f"Retry-After")
    return {"served": codes.count(200), "shed": codes.count(429)}


def _scst_loss_and_grads(cfg, params_np, state_np, batch_np, seq, rewards,
                         device):
    """The SCST loss at ``seq`` and ``rewards`` on ``device`` and its
    gradient per parameter leaf, on the host."""
    import torch
    from subgc_tpu_torch import params_from_numpy
    from subgc_tpu_torch.train.optim import tree_leaves
    from subgc_tpu_torch.train.scst import scst_loss
    from subgc_tpu_torch.train.step import batch_to_device
    p = params_from_numpy(params_np, device, requires_grad=True)
    b = batch_to_device(batch_np, device)
    dev = b.img_ix.device
    loss = scst_loss(p, params_from_numpy(state_np, device), b,
                     torch.from_numpy(seq).to(dev),
                     torch.from_numpy(rewards).to(dev), cfg)
    grads = torch.autograd.grad(loss, tree_leaves(p), allow_unused=True)
    return loss.item(), [None if g is None else g.cpu() for g in grads]


def image_refs(batch_np):
    """Each sentence's references: its image's caption rows."""
    labels = batch_np.labels[:, 1:-1]
    return [labels[batch_np.img_ix == i] for i in batch_np.img_ix]


def check_scst(label, cfg, params_np, state_np, vocab, seed, bf16):
    """Phase 22's checks before the timed steps, on SCST_CHECK_IMAGES
    images for the tokens and TRAIN_CHECK_IMAGES for the gradients:
    greedy tokens card against CPU (>= 95% identical in float32, printed
    in bf16); the sample's logprobs against their recomputation under
    autograd on the card up to each row's first EOS (atol 1e-4 in
    float32; printed in bf16, where the no-grad kernel's float32 math and
    the autograd path's bf16 roundings differ by design); the update's
    loss and gradients card against CPU at the card's sample and rewards
    (phase 14's rule, phase 20's in bf16)."""
    import torch
    from subgc_tpu_torch import params_from_numpy
    from subgc_tpu_torch.data.synthetic import synthetic_train_batch
    from subgc_tpu_torch.train.scst import (compute_rewards, make_sample_fn,
                                            sample_logprobs)
    from subgc_tpu_torch.train.step import batch_to_device
    sample_fn = make_sample_fn(cfg)
    batch_np = synthetic_train_batch(cfg, SCST_CHECK_IMAGES, seed=seed)
    out = {}
    for dev in ("cuda", "cpu"):
        g = torch.Generator(device=dev).manual_seed(seed)
        p = params_from_numpy(params_np, dev, requires_grad=dev == "cuda")
        st = params_from_numpy(state_np, dev)
        b = batch_to_device(batch_np, dev)
        out[dev] = sample_fn(p, st, b, g)
        if dev == "cuda":
            again = sample_logprobs(p, st, b, out[dev][1], cfg)
            tok = out[dev][1].cpu().numpy()
            ended = np.cumsum(tok == 0, axis=1) > 0
            live = np.concatenate([np.ones_like(ended[:, :1]),
                                   ~ended[:, :-1]], 1)
            lp_err = float(np.abs(again.detach().cpu().numpy()
                                  - out[dev][2].cpu().numpy())[live].max())
    greedy = [out[d][0].cpu().numpy() for d in ("cuda", "cpu")]
    agree = float((greedy[0] == greedy[1]).mean())
    rows = float((greedy[0] == greedy[1]).all(1).mean())
    if not bf16 and lp_err > 1e-4:
        fail(f"{label}: sample logprobs against the update's "
             f"recomputation |d| {lp_err:.3g}")
    if not bf16 and agree < 0.95:
        fail(f"{label}: greedy tokens card vs cpu agree on {agree:.3f}")
    print(f"{label}: greedy tokens card vs cpu {agree:.4f} identical (rows "
          f"{rows:.4f}); sample logprobs vs the update's recomputation max "
          f"|d| {lp_err:.3g}")
    small = synthetic_train_batch(cfg, TRAIN_CHECK_IMAGES, seed=seed + 1)
    b = batch_to_device(small, "cuda")
    greedy, sample, _ = sample_fn(
        params_from_numpy(params_np, "cuda"),
        params_from_numpy(state_np, "cuda"), b,
        torch.Generator(device="cuda").manual_seed(seed))
    seq = sample.cpu().numpy()
    cider = compute_rewards(greedy.cpu().numpy(), seq, image_refs(small),
                            vocab)
    # random weights over the full vocabulary share no n-gram with the
    # references, so every CIDEr reward is 0 and so would every gradient
    # be: the gradients are held at seeded rewards instead
    rewards = np.random.RandomState(seed).randn(len(seq)).astype("f")
    t0 = time.perf_counter()
    card, cpu = (_scst_loss_and_grads(cfg, params_np, state_np, small, seq,
                                      rewards, d) for d in ("cuda", "cpu"))
    (compare_grads_bf16 if bf16 else compare_grads)(
        f"{label} update gradients", _leaf_names(params_np), card, cpu, t0)
    return {"greedy_agreement": agree, "greedy_rows_identical": rows,
            "sample_logprob_err": lp_err, "loss_card": card[0],
            "loss_cpu": cpu[0], "cider_rewards_nonzero": int((cider != 0)
                                                              .sum())}


def run_scst_steps(label, cfg, params_np, state_np, vocab, n_steps, seed):
    """SCST steps at the preset's batch, each timed as sample (the no-grad
    dispatch and the tokens to the host), host reward and update; per
    step the row kernel of the compute dtype launches exactly 2 x
    seq_length times, no other kernel launches, and the loss is finite.
    Returns (row kernel launches, stats)."""
    import torch
    from subgc_tpu_torch import build_configs, params_from_numpy
    from subgc_tpu_torch.data.synthetic import synthetic_train_batch
    from subgc_tpu_torch.ops import attention as A
    from subgc_tpu_torch.train.scst import (compute_rewards, make_sample_fn,
                                            make_scst_update_fn)
    from subgc_tpu_torch.train.step import batch_to_device, init_train_state
    _, tcfg, _ = build_configs("Sub_GC_Kar", mode="train")
    dev = torch.device("cuda")
    ts = init_train_state(params_from_numpy(params_np, dev, True),
                          params_from_numpy(state_np, dev), tcfg,
                          step=tcfg.warmup_n + 1)
    batch_np = synthetic_train_batch(cfg, tcfg.batch_size, seed=seed)
    batch = batch_to_device(batch_np, dev)
    refs = image_refs(batch_np)
    sample_fn, update_fn = make_sample_fn(cfg), make_scst_update_fn(cfg,
                                                                    tcfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    kernel = ("ROW_BF16_LAUNCHES" if cfg.compute_dtype == "bfloat16"
              else "ROW_LAUNCHES")
    names = ("LAUNCHES", "ROW_LAUNCHES", "SHARED_BF16_LAUNCHES",
             "ROW_BF16_LAUNCHES", "PROJECT_LAUNCHES")
    times, total = [], 0
    for i in range(n_steps):
        torch.cuda.synchronize()
        A.reset_launch_counts()
        reset_gemm()
        t0 = time.perf_counter()
        greedy, sample, _ = sample_fn(ts.params, ts.model_state, batch, gen)
        g_np, s_np = greedy.cpu().numpy(), sample.cpu().numpy()
        t1 = time.perf_counter()
        rewards = compute_rewards(g_np, s_np, refs, vocab)
        t2 = time.perf_counter()
        ts, loss = update_fn(ts, batch, sample,
                             torch.from_numpy(rewards).to(sample.device), 0)
        loss = loss.item()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        counts = {n: getattr(A, n) for n in names}
        check_gemm_launches(f"{label} step {i}", 0 if cfg.compute_dtype ==
                            "bfloat16" else len(batch_np.labels),
                            2 * cfg.seq_length, calls=2)
        want = {n: 0 for n in names}
        want[kernel] = want["PROJECT_LAUNCHES"] = 2 * cfg.seq_length
        if counts != want:
            fail(f"{label} step {i}: launches {counts}, expected {want}")
        ended = np.cumsum(s_np == 0, axis=1) > 0
        if (s_np[ended] != 0).any() or not np.isfinite(loss):
            fail(f"{label} step {i}: tokens after an EOS, or loss {loss}")
        total += counts[kernel]
        times.append((1e3 * (t1 - t0), 1e3 * (t2 - t1), 1e3 * (t3 - t2)))
        print(f"{label} step {i}: loss {loss:.5f}, mean reward "
              f"{rewards.mean():.5f} ({int((rewards != 0).sum())} of "
              f"{len(rewards)} non-zero); sample {times[-1][0]:.2f} ms, host "
              f"reward {times[-1][1]:.2f} ms, update {times[-1][2]:.2f} ms; "
              f"{kernel} {counts[kernel]}")
    # the first step pays its first-use costs
    steady = times[1:] or times
    med = [statistics.median(t[j] for t in steady) for j in range(3)]
    stats = {"images": tcfg.batch_size, "sample_ms": med[0],
             "reward_ms": med[1], "update_ms": med[2],
             "step_ms": sum(med)}
    print(f"{label}: {stats['step_ms']:.2f} ms per step at "
          f"{tcfg.batch_size} images x 5 sentences = sample "
          f"{med[0]:.2f} + host reward {med[1]:.2f} + update {med[2]:.2f}")
    return total, stats


def check_optimizers(params_np):
    """Phase 22: one step of adamw, sgd, rmsprop and adagrad at full width
    on the card against the CPU, on the same clipped gradients: params
    within rtol 1e-5 of the larger of each param before and after the
    step."""
    import torch
    from subgc_tpu_torch import TrainConfig, params_from_numpy
    from subgc_tpu_torch.train import optim as O
    rng = np.random.RandomState(80)
    leaves = O.tree_leaves(params_np)
    grads = [(rng.randn(*np.shape(x)) * 1e-2).astype("f") for x in leaves]
    norm = float(np.sqrt(sum(float((g.astype("d") ** 2).sum())
                             for g in grads)))
    out = {}
    for kind in ("adamw", "sgd", "rmsprop", "adagrad"):
        tcfg = TrainConfig(optim=kind)
        res = []
        for dev in ("cuda", "cpu"):
            p = params_from_numpy(params_np, dev)
            st = O.init_opt_state(p, tcfg)
            O.apply_update(p, [torch.from_numpy(g).to(x.device) for g, x in
                               zip(grads, O.tree_leaves(p))], st, 5e-4, tcfg)
            res.append([t.cpu() for t in O.tree_leaves(p)])
        worst = 0.0
        for a, b, x in zip(res[0], res[1], leaves):
            # relative to the larger of the param before and after: a step
            # that cancels a param leaves a small value that carries its
            # operands' rounding
            scale = torch.maximum(b.abs(), torch.from_numpy(np.abs(x)))
            rel = (a - b).abs() / scale.clamp_min(1e-30)
            if (rel > 1e-5).any():
                fail(f"optimizer {kind}: card vs cpu |d| "
                     f"{rel.max().item():.3g} of the param's scale, beyond "
                     f"rtol 1e-5")
            worst = max(worst, rel.max().item())
        out[kind] = worst
        print(f"optimizer {kind}: one step at full width (gradient norm "
              f"{norm:.1f}, clip at 10), card vs cpu worst relative param "
              f"error {worst:.3g}")
    return out


def run_scst(params_np, state_np):
    """Phase 22: SCST on Sub_GC_Kar at 64 images x 5 sentences, 3 steps in
    float32 and 1 in bf16 + bf16 gates, and the four other optimizers.
    Returns (row launches, row bf16 launches, stats)."""
    from subgc_tpu_torch import build_configs
    cfg, _, _ = build_configs("Sub_GC_Kar", mode="train")
    vocab = {str(i): f"w{i}" for i in range(1, cfg.vocab_size + 1)}
    stats = {"float32": check_scst("SCST float32", cfg, params_np, state_np,
                                   vocab, seed=90, bf16=False)}
    row, stats["float32"]["steps"] = run_scst_steps(
        "SCST float32", cfg, params_np, state_np, vocab, 3, seed=91)
    bcfg, _, _ = build_configs("Sub_GC_Kar", mode="train", model=BF16_MODEL)
    stats["bfloat16"] = check_scst("SCST bf16", bcfg, params_np, state_np,
                                   vocab, seed=92, bf16=True)
    row_bf16, stats["bfloat16"]["steps"] = run_scst_steps(
        "SCST bf16", bcfg, params_np, state_np, vocab, 1, seed=93)
    stats["optimizers_worst_rel_err"] = check_optimizers(params_np)
    return row, row_bf16, stats


# ---- diverse beam groups (phase 23)

DIVERSE = dict(beam_size=4, group_size=2, diversity_lambda=0.5)


def run_diverse(params, cpu_params, state, examples, vocab):
    """Phase 23: Sub_GC_Kar in diverse beam groups (beam 4 in 2 groups of
    2, lambda 0.5) on phase 4's first 16 images, float32 and bf16 + bf16
    gates: the dtype's shared kernel exactly G x seq_length launches (one
    per active group and step) and no other; card against CPU: identical
    keep sets; float32 >= 95% identical captions, scores rtol 1e-4; bf16
    scores within 2e-2, caption agreement printed (phase 18's rule: a
    near-tie flips a word).  Then the shared kernel alone at the groups'
    shape in both dtypes.  Returns ({dtype: launches}, stats, checks)."""
    import torch
    from subgc_tpu_torch import build_configs, run_test_split
    from subgc_tpu_torch.ops import attention as A
    ex = examples[:BATCH_IMAGES]
    loader = MemoryLoader(ex)
    launches, stats = {}, {}
    for dtype, model in (("float32", {}), ("bfloat16", BF16_MODEL)):
        cfg, ecfg, _ = build_configs(
            "Sub_GC_Kar", model=model,
            eval=dict(max_subgraph_bucket=BUCKET, **DIVERSE))
        run_test_split(params, state, loader, cfg, ecfg, vocab,
                       verbose=False, batch_images=BATCH_IMAGES,
                       device="cuda")                       # warm-up
        torch.cuda.synchronize()
        A.reset_launch_counts()
        reset_gemm()
        preds, wall, n_caps = run_test_split(
            params, state, loader, cfg, ecfg, vocab, verbose=False,
            batch_images=BATCH_IMAGES, device="cuda")
        # each group's beams: beam_size / group_size of them a row
        check_gemm_launches(
            f"diverse {dtype}", 0 if dtype == "bfloat16" else dispatch_rows(
                preds, BATCH_IMAGES, ecfg.beam_size // ecfg.group_size,
                ecfg.gpn_max_subg),
            ecfg.group_size * cfg.seq_length)
        name = "LAUNCHES" if dtype == "float32" else "SHARED_BF16_LAUNCHES"
        n = getattr(A, name)
        others = (A.LAUNCHES + A.ROW_LAUNCHES + A.SHARED_BF16_LAUNCHES
                  + A.ROW_BF16_LAUNCHES - n)
        want = ecfg.group_size * cfg.seq_length
        if n != want or others:
            fail(f"diverse {dtype}: shared kernel launched {n} times and the "
                 f"others {others}; expected {ecfg.group_size} groups x "
                 f"{cfg.seq_length} steps = {want} and 0")
        check_project_launches(f"diverse {dtype}", n)
        check_predictions(preds, len(ex), ecfg.gpn_max_subg)
        _, dec_ms = phase_times(params, state, ex, cfg, ecfg,
                                torch.device("cuda"))
        t0 = time.perf_counter()
        cpu_preds, _, _ = run_test_split(
            cpu_params, state, loader, cfg, ecfg, vocab, verbose=False,
            batch_images=BATCH_IMAGES, device="cpu")
        cpu_s = time.perf_counter() - t0
        if dtype == "float32":
            same, total = compare_card_cpu(preds, cpu_preds)
            if same < 0.95 * total:
                fail(f"diverse float32: only {same}/{total} captions agree "
                     f"between card and cpu")
            worst = None
        else:
            worst = 0.0
            for g, c in zip(preds, cpu_preds):
                gs = dict(zip(np.asarray(g["sorted_subgraph_ind"]).tolist(),
                              g["subgraph_score"]))
                cs = dict(zip(np.asarray(c["sorted_subgraph_ind"]).tolist(),
                              c["subgraph_score"]))
                if sorted(gs) != sorted(cs):
                    fail(f"diverse bf16: image {g['image_id']} keep sets "
                         f"differ card {sorted(gs)} cpu {sorted(cs)}")
                worst = max([worst] + [abs(gs[k] - cs[k]) for k in gs])
            if worst > 2e-2:
                fail(f"diverse bf16: sGPN scores card vs cpu differ by "
                     f"{worst:.3g} > 2e-2")
            same, total = caption_agreement(preds, cpu_preds)
        print(f"diverse groups {dtype} (Sub_GC_Kar, beam 4 in 2 groups, "
              f"lambda 0.5): {len(ex)} images, {n_caps} captions in "
              f"{wall:.3f} s = {n_caps / wall:.1f} captions/s, beam decode "
              f"{dec_ms:.2f} ms; shared kernel launches {n} = "
              f"{ecfg.group_size} x {cfg.seq_length}; card vs cpu "
              f"({cpu_s:.1f} s on cpu): keep sets identical, {same}/{total} "
              f"captions identical"
              + (f", sGPN scores within {worst:.3g}" if worst is not None
                 else ""))
        launches[dtype] = n
        stats[dtype] = {"images": len(ex), "captions": n_caps,
                        "captions_per_s": n_caps / wall, "decode_ms": dec_ms,
                        "launches": n, "captions_vs_cpu": [same, total]}
    # the kernel alone at the groups' shape: image-shared, S = 16 images x
    # keep 10, B = beam_size / group_size
    bdash = DIVERSE["beam_size"] // DIVERSE["group_size"]
    checks = {"float32": check_attention(params, "image", BATCH_IMAGES * 10,
                                         BATCH_IMAGES, seed=70, beams=bdash),
              "bfloat16": check_attention(params, "image", BATCH_IMAGES * 10,
                                          BATCH_IMAGES, seed=71, beams=bdash,
                                          bf16=True)}
    stats["kernel"] = checks
    return launches, stats, checks


# ---- the host library and the input path (phase 24)

HOST_IMAGES = 64        # phase 4's images; the packed shard's records
HOST_SUBGRAPHS = 1000   # sub-graphs a record holds: the Karpathy banks' size
PREFETCH_STEPS = 3


def host_ms(fn, n):
    """Host ms per item of ``fn()`` over ``n`` items (median of 3 runs)."""
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0) / n)
    return statistics.median(times)


def check_scorer_cores(preds):
    """The C++ scorer cores against their Python paths on phase 4's
    captions: per image the tokenizer on its captions, mBLEU-4 among them
    and pairwise CIDEr against the next 5 images' captions under a df
    corpus of every image's captions; within rtol 1e-10.  Each pass is
    timed once (the Python one takes ~5 s)."""
    from subgc_tpu_torch.eval import pairwise as PP
    caps = [list(p["caption"]) for p in preds]
    n = len(caps)

    def run(tok, mb4, cider):
        toks = [tok(c) for c in caps]
        out = []
        for i in range(n):
            refs = [s for j in range(1, 6) for s in toks[(i + j) % n]]
            out.append((mb4(toks[i]), cider(toks, toks[i], refs)))
        return toks, out

    t0 = time.perf_counter()
    ta, a = run(PP.ptb_tokenize_batch, PP.mutual_bleu4,
                PP.pairwise_cider_matrix)
    t1 = time.perf_counter()
    tb, b = run(PP.ptb_tokenize_batch_plain, PP.mutual_bleu4_plain,
                PP.pairwise_cider_matrix_plain)
    t2 = time.perf_counter()
    if ta != tb:
        fail("the C++ tokenizer disagrees with its Python path")
    worst = 0.0
    for (ma, ca), (mb, cb) in zip(a, b):
        for x, y in ((ma, mb), (ca, cb)):
            rel = np.abs(x - y) / np.maximum(np.abs(y), 1e-300)
            worst = max(worst, float(rel.max()) if rel.size else 0.0)
    if worst > 1e-10:
        fail(f"C++ scorer cores vs Python paths: relative error {worst:.3g} "
             f"> 1e-10")
    res = {"cpp_ms_per_image": 1e3 * (t1 - t0) / n,
           "python_ms_per_image": 1e3 * (t2 - t1) / n, "max_rel_err": worst}
    print(f"scorer cores on {n} images x {len(caps[0])} captions (tokenize, "
          f"mBLEU-4, pairwise CIDEr vs 50): C++ {res['cpp_ms_per_image']:.3f}"
          f" ms / image, Python {res['python_ms_per_image']:.3f} ms / image "
          f"(host), max relative difference {worst:.3g}")
    return res


def full_size_image(rng, cfg, n_subg):
    """One image's npz dicts at full size: 36 detections of 2048 features
    and 1599 classes, 64 relations, a bank of 5 + n_subg sub-graphs."""
    N, K = cfg.obj_num - 1, cfg.rel_num - 1
    sg = {"object_fmap": rng.rand(N, cfg.att_feat_size).astype("f"),
          "object_dist": rng.rand(N, cfg.num_obj_classes).astype("f"),
          "rel_ind": rng.randint(0, N, (K, 2)).astype(np.int64),
          "pred_dist": rng.rand(K, cfg.num_rel_classes).astype("f"),
          "boxes": (rng.rand(N, 4) * 296).astype("f")}
    total = 5 + n_subg
    obj = rng.rand(total, N) < 0.15
    obj[np.arange(total), rng.randint(0, N, total)] = True
    pred = rng.rand(total, K) < 0.1
    entries = [[None, o.astype(np.int64), p.astype(np.int64),
                np.zeros((0, 2), np.int64), o.nonzero()[0][:1]]
               for o, p in zip(obj, pred)]
    return sg, {"node_iou_mtx": rng.rand(5, total).astype("f"),
                "subgraph_mask_list": entries}


def check_packed_shard(cfg, workdir):
    """A 64-image shard written by the port at full width, its records read
    by the C++ and the numpy readers (equal, field for field, and equal to
    what was packed); the gather per image against the npz read."""
    from subgc_tpu_torch.data import packed as P
    from subgc_tpu_torch.io.sg_npz import SGDir, write_feat_npz
    rng = np.random.RandomState(24)
    spec = P.PackedSpec(feat_dim=cfg.att_feat_size,
                        n_obj_cls=cfg.num_obj_classes,
                        n_rel_cls=cfg.num_rel_classes,
                        max_subg=HOST_SUBGRAPHS)
    sg_dir, mask_dir = (os.path.join(workdir, d) for d in ("sg", "mask"))
    os.makedirs(sg_dir)
    os.makedirs(mask_dir)
    records, t0 = [], time.perf_counter()
    for i in range(HOST_IMAGES):
        sg, bank = full_size_image(rng, cfg, HOST_SUBGRAPHS)
        write_feat_npz(os.path.join(sg_dir, f"{i}.npz"), sg)
        write_feat_npz(os.path.join(mask_dir, f"{i}.npz"), bank)
        records.append(P.pack_image(spec, i, sg, bank))
    path = os.path.join(workdir, "shard.bin")
    P.write_shard(path, spec, records)
    write_s = time.perf_counter() - t0
    native = P.PackedShard(path, use_native=True)
    plain = P.PackedShard(path, use_native=False)
    names = [n for n, _, _ in spec.record_fields()]
    for i in range(HOST_IMAGES):
        a, b = native.record(i), plain.record(i)
        for name in names:
            if name == "img_id":
                same = a[name] == b[name] == i
            else:
                same = np.array_equal(a[name], b[name])
            if not same:
                fail(f"packed shard: record {i} field {name} differs "
                     f"between the C++ and numpy readers")
    whole = native._native.gather(range(HOST_IMAGES))
    if any(whole[i].tobytes() != records[i] for i in range(HOST_IMAGES)):
        fail("packed shard: a gathered record differs from what was packed")
    sgd, maskd = SGDir(sg_dir), SGDir(mask_dir)
    order = np.random.RandomState(1).permutation(HOST_IMAGES)
    res = {"record_mb": spec.record_size / 2 ** 20,
           "shard_mb": os.path.getsize(path) / 2 ** 20,
           "write_s": write_s,
           "native_gather_ms_per_image": host_ms(
               lambda: [native._native.gather([i]) for i in order],
               HOST_IMAGES),
           "npz_read_ms_per_image": host_ms(
               lambda: [(sgd.get(i), maskd.get(i)) for i in order],
               HOST_IMAGES)}
    print(f"packed shard: {HOST_IMAGES} records of {res['record_mb']:.3f} "
          f"MiB ({res['shard_mb']:.1f} MiB, written with its npz in "
          f"{write_s:.1f} s); C++ and numpy readers equal on every field; "
          f"C++ gather {res['native_gather_ms_per_image']:.3f} ms / image "
          f"against the npz read {res['npz_read_ms_per_image']:.3f} ms / "
          f"image (host)")
    return res, mask_dir


def time_samplers(tcfg, mask_dir):
    """The C++ and Python positive/negative samplers on the shard's
    full-size node-IoU matrices (5 x 1005), host ms per image."""
    from subgc_tpu_torch.data.dataset import sample_pos_neg
    from subgc_tpu_torch.io.sg_npz import SGDir
    from subgc_tpu_torch.ops.native import sample_pos_neg_native
    ious = [SGDir(mask_dir).get(i)["node_iou_mtx"]
            for i in range(HOST_IMAGES)]
    half, thres, spi = tcfg.gpn_batch, tcfg.gpn_label_thres, tcfg.seq_per_img

    def cpp():
        return [sample_pos_neg_native(m, thres, half, spi, seed=i)
                for i, m in enumerate(ious)]

    def plain():
        rng = np.random.RandomState(0)
        return [sample_pos_neg(m, thres, half, spi, rng) for m in ious]

    for idx in cpp() + plain():
        if idx is None or idx.shape != (spi, half, 2) or idx.min() < 0 \
                or idx.max() >= ious[0].shape[1]:
            fail("sampler: an index set out of shape or range")
    res = {"cpp_ms_per_image": host_ms(cpp, HOST_IMAGES),
           "python_ms_per_image": host_ms(plain, HOST_IMAGES)}
    print(f"pos/neg sampler on 5 x {ious[0].shape[1]} node-IoU matrices: "
          f"C++ {res['cpp_ms_per_image']:.4f} ms / image, Python "
          f"{res['python_ms_per_image']:.4f} ms / image (host)")
    return res


def run_prefetched_steps(params_np, state_np, dev="cuda"):
    """Three Sub_GC_Kar float32 train steps (64 images) from batches a
    ``BatchPrefetcher`` copies to the card on its own stream, against the
    same batches copied synchronously from the same params and generator:
    losses and params bitwise equal.  Both runs use PyTorch's deterministic
    algorithms, so that any difference is the input path's."""
    import torch
    from subgc_tpu_torch import build_configs
    from subgc_tpu_torch.data.prefetch import BatchPrefetcher
    from subgc_tpu_torch.data.synthetic import synthetic_train_batch
    from subgc_tpu_torch.models.params import params_from_numpy
    from subgc_tpu_torch.train.optim import tree_leaves
    from subgc_tpu_torch.train.step import (batch_to_device,
                                            init_train_state, make_train_step)
    from subgc_tpu_torch.utils.profiling import PhaseTimers
    cfg, tcfg, _ = build_configs("Sub_GC_Kar", mode="train")
    dev = torch.device(dev)
    batches = [synthetic_train_batch(cfg, tcfg.batch_size, seed=240 + i)
               for i in range(PREFETCH_STEPS)]
    step = make_train_step(cfg, tcfg, ss_active=False)

    def run(next_batch, timers):
        ts = init_train_state(params_from_numpy(params_np, dev, True),
                              params_from_numpy(state_np, dev), tcfg)
        gen = torch.Generator(device=dev).manual_seed(24)
        losses = []
        for _ in range(PREFETCH_STEPS):
            with timers.phase("data"):      # host wait for the batch
                batch = next_batch()
            with timers.phase("step", sync=dev):
                ts, m = step(ts, batch, gen, 0, 0.0)
            losses.append(m["loss"])
        return losses, [t.detach() for t in tree_leaves(ts.params)]

    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        sync_t = PhaseTimers()
        it = iter(batches)
        sync = run(lambda: batch_to_device(next(it), dev), sync_t)
        counter = iter(range(10 ** 6))

        def get_batch():
            return batches[next(counter) % PREFETCH_STEPS], None, False

        pre_t = PhaseTimers()
        prefetch = BatchPrefetcher(
            get_batch, depth=2, device=dev,
            place=lambda b: batch_to_device(
                b, dev, non_blocking=dev.type == "cuda"))
        try:
            pre = run(lambda: prefetch.next()[0], pre_t)
        finally:
            prefetch.stop()
    finally:
        torch.use_deterministic_algorithms(det)
    if prefetch.thread.is_alive():
        fail("prefetch: the producer thread did not stop")
    diff = max((a - b).abs().max().item() for a, b in zip(sync[1], pre[1]))
    if not (all(torch.equal(a, b) for a, b in zip(sync[0], pre[0]))
            and all(torch.equal(a, b) for a, b in zip(sync[1], pre[1]))):
        fail(f"prefetched train steps differ from synchronous ones: losses "
             f"{[x.item() for x in pre[0]]} vs {[x.item() for x in sync[0]]}"
             f", params max |d| {diff:.3g}")
    s, p = sync_t.summary(), pre_t.summary()
    res = {"losses": [x.item() for x in sync[0]],
           "sync_data_ms": s["data"]["mean_ms"],
           "sync_step_ms": s["step"]["mean_ms"],
           "prefetch_data_ms": p["data"]["mean_ms"],
           "prefetch_step_ms": p["step"]["mean_ms"]}
    print(f"prefetched train steps (Sub_GC_Kar float32, {tcfg.batch_size} "
          f"images): losses and params bitwise equal to synchronous "
          f"loading; synchronous: data {res['sync_data_ms']:.2f} + step "
          f"{res['sync_step_ms']:.2f} ms; prefetched: data "
          f"{res['prefetch_data_ms']:.2f} + step {res['prefetch_step_ms']:.2f}"
          f" ms (mean of {PREFETCH_STEPS})")
    return res


def run_host(preds, params_np, state_np):
    """Phase 24: the host library built from ``native/``, the scorer cores,
    the packed shard and its readers, both samplers, and prefetched train
    steps.  Returns the stats printed."""
    import tempfile
    from subgc_tpu_torch import build_configs
    from subgc_tpu_torch.ops import _build, native, native_packed
    stats = {"build_s": {}}
    for name, mod in (("subgc_native", native),
                      ("packed_reader", native_packed)):
        mod.library()
        stats["build_s"][name] = _build.BUILD_INFO[name]["seconds"]
    print(f"host library from native/: g++ "
          + ", ".join(f"{k} {v:.2f} s" for k, v in stats["build_s"].items()))
    stats["scorers"] = check_scorer_cores(preds)
    cfg, tcfg, _ = build_configs("Sub_GC_Kar", mode="train")
    with tempfile.TemporaryDirectory() as workdir:
        stats["packed"], mask_dir = check_packed_shard(cfg, workdir)
        stats["sampler"] = time_samplers(tcfg, mask_dir)
    stats["prefetch"] = run_prefetched_steps(params_np, state_np)
    return stats


# ---- parallelism (phases 25-26)

def phase_mesh():
    """Phase 25's mesh: every card when there are two or more, else
    ``cuda:0`` twice (the shards take turns on the one card)."""
    import torch
    from subgc_tpu_torch.parallel.mesh import make_mesh
    n = torch.cuda.device_count()
    return make_mesh() if n >= 2 else make_mesh(devices=["cuda:0"] * 2)


def compare_sharded(label, got, want, launches, expect, wall, base_wall,
                    batches):
    """Phase 25's checks of a sharded decode against its unsharded run:
    identical keep sets, sGPN scores rtol 1e-5, >= 95% identical captions
    (a float near-tie in a beam step may flip a word: the shards' GEMM and
    kernel shapes differ from the whole batch's), the kernel's launches.
    ``wall`` / ``base_wall``: seconds for all ``batches`` dispatches."""
    n_same = n_total = 0
    for g, w in zip(got, want, strict=True):
        gi = np.asarray(g["sorted_subgraph_ind"])
        wi = np.asarray(w["sorted_subgraph_ind"])
        if sorted(gi.tolist()) != sorted(wi.tolist()):
            fail(f"{label}: image {g['image_id']} keep sets differ: "
                 f"sharded {gi} unsharded {wi}")
        gs = dict(zip(gi.tolist(), g["subgraph_score"]))
        ws = dict(zip(wi.tolist(), w["subgraph_score"]))
        if any(abs(gs[k] - ws[k]) > 1e-5 * abs(ws[k]) for k in ws):
            fail(f"{label}: image {g['image_id']} sGPN scores differ")
        gc = dict(zip(gi.tolist(), g["caption"]))
        wc = dict(zip(wi.tolist(), w["caption"]))
        n_total += len(wc)
        n_same += sum(gc[k] == wc[k] for k in wc)
    if launches != expect:
        fail(f"{label}: beam-shared kernel launched {launches} times, "
             f"expected {expect}")
    print(f"{label}: {n_same}/{n_total} captions identical to the "
          f"unsharded run, keep sets identical; {launches} kernel launches; "
          f"wall per batch over {batches} batches sharded "
          f"{1e3 * wall / batches:.2f} ms, unsharded "
          f"{1e3 * base_wall / batches:.2f} ms")
    if n_same < 0.95 * n_total:
        fail(f"{label}: only {n_same}/{n_total} captions agree")
    return {"captions_same": n_same, "captions": n_total,
            "launches": launches, "batches": batches,
            "sharded_ms": 1e3 * wall / batches,
            "unsharded_ms": 1e3 * base_wall / batches}


def check_wrong_device_launch(params_np):
    """Phase 25d (two cards or more): both kernels (and the projection
    alone) on ``cuda:1``, launched from a thread whose current device is
    ``cuda:0``, against their plain versions there."""
    import threading
    import torch
    from subgc_tpu_torch import params_from_numpy
    from subgc_tpu_torch.ops import attention as A
    dev = torch.device("cuda", 1)
    params = params_from_numpy(params_np, dev)
    shared = attention_inputs(params, "image", 160, 16, seed=70)
    x = attention_inputs(params, "subgraph", 160, 160, seed=71, beams=1)
    row = [x[0][:, 0], x[1], x[2], x[3], x[5], x[6], x[7], x[8]]
    out, err = {}, []

    def work():
        try:
            torch.cuda.set_device(0)
            with torch.no_grad():
                out["shared"] = A.shared_attention(*shared)
                out["row"] = A.row_attention(*row)
                out["project"] = A.attention_project(row[0], row[4], row[5])
            torch.cuda.synchronize(dev)
        except Exception as e:          # re-raised below
            err.append(e)

    t = threading.Thread(target=work)
    t.start()
    t.join()
    if err:
        fail(f"launch on cuda:1 from a thread on cuda:0 failed: {err[0]}")
    worst = 0.0
    for name, ref in (("shared", A.shared_attention_ref(*shared)),
                      ("row", A.row_attention_ref(*row))):
        (o, w), (r_o, r_w) = out[name], ref
        if o.device != dev:
            fail(f"{name} kernel's output on {o.device}, inputs on {dev}")
        e_w = (w - r_w).abs().max().item()
        bad = ((o - r_o).abs() > 1e-4 + 1e-4 * r_o.abs()).sum().item()
        if e_w > 1e-5 or bad:
            fail(f"{name} kernel on cuda:1 from cuda:0 disagrees with its "
                 f"plain version: |dw| {e_w:.3g}, {bad} att_res entries")
        worst = max(worst, e_w, (o - r_o).abs().max().item())
    e_p = (out["project"] - A.attention_project_ref(
        row[0], row[4], row[5])).abs().max().item()
    if e_p > 1e-4:
        fail(f"projection on cuda:1 from cuda:0: max |err| {e_p:.3g}")
    print(f"wrong-device launch: both kernels and the projection on cuda:1 "
          f"from a thread on cuda:0 agree with their plain versions "
          f"(max |err| {max(worst, e_p):.3g})")
    return max(worst, e_p)


def run_sharded(params, params_np, state, examples, preds, fan_examples,
                fan_preds, vocab):
    """Phase 25: sharded decode and --shard_fanout serving on the mesh of
    ``phase_mesh``, each against its unsharded run, timed over several
    dispatches with the model already on every mesh device (the copy is
    timed on its own).  Returns (beam-shared kernel launches of the sharded
    runs, the kernel checks at the shards' shapes, stats)."""
    import torch
    from subgc_tpu_torch import build_configs, run_test_split
    from subgc_tpu_torch.cli import serve as SV
    from subgc_tpu_torch.ops import attention as A
    from subgc_tpu_torch.parallel import mesh as M
    mesh = phase_mesh()
    n = mesh.size
    stats = {"mesh": [str(d) for d in mesh.devices]}
    print(f"phase 25 mesh: {stats['mesh']}")
    # both kernels alone at the shards' shapes: 16 Kar images / n per shard
    # (image-shared, keep 10), and a keep-1000 image's rows in 2 chunks
    checks = [check_attention(params, "image", BATCH_IMAGES // n * 10,
                              BATCH_IMAGES // n, seed=80),
              check_attention(params, "image", 500, 1, seed=81, beams=1)]

    def sync_mesh():
        for d in set(mesh.devices):
            torch.cuda.synchronize(d)

    def timed(fn):
        """fn's result and wall seconds, after a warm-up call; the launch
        counters are zeroed just before the timed call."""
        fn()
        sync_mesh()
        A.reset_launch_counts()
        reset_gemm()
        t0 = time.perf_counter()
        out = fn()
        sync_mesh()
        return out, time.perf_counter() - t0

    # the model on every mesh device, once, outside the timed decodes
    sync_mesh()
    t0 = time.perf_counter()
    params_m, state_m = M.replicate(mesh, params), M.replicate(mesh, state)
    sync_mesh()
    stats["replicate_ms"] = 1e3 * (time.perf_counter() - t0)
    print(f"model copied to the mesh in {stats['replicate_ms']:.2f} ms "
          f"(a device that already holds it shares its tensors)")

    # (a) the image axis: Sub_GC_Kar on phase 4's images, 16 a dispatch
    cfg, ecfg, _ = build_configs("Sub_GC_Kar",
                                 eval=dict(max_subgraph_bucket=BUCKET))
    loader = MemoryLoader(examples)
    batches = N_IMAGES // BATCH_IMAGES
    kw = dict(num_images=N_IMAGES, verbose=False, batch_images=BATCH_IMAGES)
    _, base = timed(lambda: run_test_split(params, state, loader, cfg, ecfg,
                                           vocab, device="cuda", **kw))
    (got, _, _), wall = timed(lambda: run_test_split(
        params_m, state_m, loader, cfg, ecfg, vocab, mesh=mesh,
        shard_axis="image", **kw))
    launches = A.LAUNCHES
    check_project_launches("image-axis sharded path", launches)
    check_gemm_launches("image-axis sharded path", dispatch_rows(
        got, BATCH_IMAGES // n, ecfg.beam_size, ecfg.gpn_max_subg),
        cfg.seq_length)
    stats["image_axis"] = compare_sharded(
        f"image axis (Sub_GC_Kar, {N_IMAGES} images)", got,
        preds[:N_IMAGES], launches, batches * n * cfg.seq_length, wall,
        base, batches)
    total = launches

    # (b) the sub-graph axis: Sub_GC_MRNN keep 1000, phase 8's images one
    # a dispatch, each image's 1000 rows in 2 chunks of 500
    mesh2 = M.Mesh(mesh.devices[:2])
    cfg, ecfg, _ = build_configs("Sub_GC_MRNN",
                                 eval=dict(max_subgraph_bucket=FANOUT_BUCKET))
    loader = MemoryLoader(fan_examples)
    kw = dict(num_images=FANOUT_IMAGES, verbose=False, batch_images=1)
    _, base = timed(lambda: run_test_split(params, state, loader, cfg, ecfg,
                                           vocab, device="cuda", **kw))
    (got, _, _), wall = timed(lambda: run_test_split(
        params_m[:2], state_m[:2], loader, cfg, ecfg, vocab, mesh=mesh2,
        shard_axis="subgraph", **kw))
    launches = A.LAUNCHES
    check_project_launches("sub-graph-axis sharded path", launches)
    # each image's kept prefix of its 1000 slots, in 2 chunks of 500
    check_gemm_launches("sub-graph-axis sharded path", [
        int(np.clip(len(p["caption"]) - c * 500, 0, 500))
        for p in got for c in range(2)], cfg.seq_length)
    stats["subgraph_axis"] = compare_sharded(
        "sub-graph axis (Sub_GC_MRNN, keep 1000, 2 x 500 rows)", got,
        fan_preds[:FANOUT_IMAGES], launches,
        FANOUT_IMAGES * 2 * cfg.seq_length, wall, base, FANOUT_IMAGES)
    total += launches

    # (c) --shard_fanout serving, float32, phase 21's 32 burst images in
    # dispatches of 8; building a service places the model on its devices
    cfg, ecfg, _ = build_configs("Sub_GC_Kar",
                                 eval=dict(max_subgraph_bucket=BUCKET))
    imgs = [request_image(ex) for ex in examples[:SERVE_IMAGES]]
    kw = dict(default_dtype="float32", batch_images=SERVE_BATCH)
    t0 = time.perf_counter()
    single = SV.ModelService(params_np, state, cfg, ecfg, vocab,
                             device="cuda", **kw)
    sync_mesh()
    t1 = time.perf_counter()
    sharded = SV.ModelService(params_np, state, cfg, ecfg, vocab, mesh=mesh,
                              **kw)
    sync_mesh()
    setup = (1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t1))
    print(f"serving set-up (the model placed on its devices): one card "
          f"{setup[0]:.2f} ms, the mesh {setup[1]:.2f} ms")
    want, base = timed(lambda: single(imgs))
    got, wall = timed(lambda: sharded(imgs))
    launches = A.LAUNCHES
    check_project_launches("sharded serving", launches)
    check_gemm_launches("sharded serving", serving_rows(
        [len(r["captions"]) for r in want], ecfg.beam_size), launches)
    as_preds = [[{"image_id": r["id"], "caption": r["captions"],
                  "subgraph_score": np.asarray(r["scores"]),
                  "sorted_subgraph_ind": np.arange(len(r["scores"]))}
                 for r in rs] for rs in (got, want)]
    # the answers carry no sub-graph ids: held in score order
    batches = SERVE_IMAGES // SERVE_BATCH
    stats["serving"] = compare_sharded(
        f"--shard_fanout serving (float32, {SERVE_IMAGES} images)",
        *as_preds, launches, batches * n * cfg.seq_length, wall, base,
        batches)
    stats["serving"]["setup_ms"] = setup
    total += launches

    # (d) a launch on cuda:1 from a thread whose current device is cuda:0
    if torch.cuda.device_count() >= 2:
        stats["wrong_device_max_err"] = check_wrong_device_launch(params_np)
    return total, checks, stats


def dp_batch(cfg, n_images, seed):
    """A synthetic train batch whose sentences have random lengths (3..13
    tokens), so that the ranks' token counts differ."""
    from subgc_tpu_torch.data.synthetic import synthetic_train_batch
    b = synthetic_train_batch(cfg, n_images, seed)
    lengths = np.random.RandomState(seed + 100).randint(3, 14,
                                                        b.masks.shape[0])
    m = np.arange(b.masks.shape[1])[None] < lengths[:, None]
    return b._replace(masks=m.astype(np.float32))


def check_ranks(label, reports, ref, control, cfg):
    """Phase 26's checks of one spec's ranks against the single-process
    run: every metric rtol 1e-5; the gradients the optimizer gets, summed
    over the ranks, in the first step with a learning rate above 0
    (``parallel/steps.py::same_gradients``: the whole within
    ``DP_WHOLE_ULPS`` times the distance of ``control``, the one-process
    run from weights one ulp away, and at least 2e-4, each leaf
    ``DP_LEAF_RTOL``, the zero-gradient leaves float noise); running
    statistics rtol 2e-4 / atol 1e-6; the same parameter bits on every
    rank; each rank's global val loss rtol 1e-5, and its val pass through
    the row kernel (seq_length + 1 launches, the projection with each).
    The parameters after Adam are not held to the one-process step's: an
    element whose small gradient a flipped ReLU turned to the other sign
    moves by up to the learning rate the other way."""
    from subgc_tpu_torch.parallel import steps as PS
    for g, w in zip(reports[0]["metrics"], ref["metrics"], strict=True):
        for k in w:
            if abs(g[k] - w[k]) > 1e-7 + 1e-5 * abs(w[k]):
                fail(f"{label}: {k} {g[k]} against one process's {w[k]}")
    zero = PS.zero_gradient_leaves(ref["params"])

    def summary(got):
        err = PS.gradient_errors(got, ref)
        worst = sorted(((e, k) for k, (e, _) in err.items()
                        if k and k not in zero), reverse=True)[:4]
        return float(err[""][0]), worst

    whole, worst = summary(reports[0])
    c_whole, c_worst = summary(control)
    print(f"{label}: gradients against one process's, |dg| / |g|: whole "
          f"{whole:.3g}, worst leaves "
          + ", ".join(f"{k} {e:.3g}" for e, k in worst)
          + f"; one process from weights one ulp away: whole {c_whole:.3g},"
          f" worst leaf {c_worst[0][1]} {c_worst[0][0]:.3g}")
    bad = PS.same_gradients(reports[0], ref,
                            rtol=max(2e-4, DP_WHOLE_ULPS * c_whole),
                            leaf_rtol=DP_LEAF_RTOL)
    if bad:
        fail(f"{label}: gradients differ from one process's (leaf, |dg| / "
             f"|g|; '' the whole): {bad[:8]}")
    bad = PS.same_parameters(reports[0], ref, parts=("state",))
    if bad:
        fail(f"{label}: running statistics differ from one process's "
             f"(leaf, max |diff|, elements beyond, elements): {bad[:8]}")
    show_parameter_moves(label, reports[0], ref)
    if len({r["checksum"] for r in reports}) != 1:
        fail(f"{label}: the ranks' parameters differ")
    want = {"row": cfg.seq_length + 1, "shared": 0,
            "project": cfg.seq_length + 1}
    for r in reports:
        if abs(r["val_loss"] - ref["val_loss"]) > 1e-5 * abs(ref["val_loss"]):
            fail(f"{label}: val loss {r['val_loss']} against one "
                 f"process's {ref['val_loss']}")
        if r["val_launches"] != want:
            fail(f"{label}: val pass launches {r['val_launches']} on "
                 f"{r['device']}, expected {want}")
    row = {"ranks": len(reports), "backend": reports[0]["backend"],
           "devices": [r["device"] for r in reports],
           "step_ms": [r["step_ms"] for r in reports],
           "single_step_ms": ref["step_ms"],
           "allreduce_ms": reports[0].get("allreduce_ms"),
           "bucket_mib": reports[0].get("bucket_mib"),
           "startup_s": [r["startup_s"] for r in reports],
           "loss": [m["loss"] for m in reports[0]["metrics"]],
           "val_loss": reports[0]["val_loss"],
           "grad_rel": whole,
           "grad_worst_leaves": [(k, float(e)) for e, k in worst],
           "grad_rel_one_ulp": c_whole}
    print(f"{label}: {row['ranks']} ranks ({row['backend']} on "
          f"{row['devices']}) match one process: losses "
          f"{row['loss']}, val {row['val_loss']:.6f}, same bits on every "
          f"rank; ms per step per rank {row['step_ms']} (one process "
          f"{ref['step_ms']}); gradient bucket {row['bucket_mib']:.1f} MiB "
          f"all-reduce {row['allreduce_ms']:.2f} ms; start-up "
          f"{row['startup_s']} s")
    return row


def show_parameter_moves(label, got, ref):
    """Prints (holds nothing) the parameter elements that Adam moved
    beyond rtol 2e-4 / atol 1e-6 of the one-process step's: their indices
    and the gradients the two runs gave them, and for a 2-d leaf the column
    that holds most of its gradient difference."""
    from subgc_tpu_torch.parallel import steps as PS
    moved = PS.same_parameters(got, ref, parts=("params",))
    p_a, p_b = dict(PS._flat(got["params"])), dict(PS._flat(ref["params"]))
    g_a, g_b = dict(PS._flat(got["grads"])), dict(PS._flat(ref["grads"]))
    for name, _, n_over, size in moved[:3]:
        k = name[len("params."):]
        diff = np.abs(p_a[k] - p_b[k])
        over = np.argwhere(diff > 1e-6 + 2e-4 * np.abs(p_b[k]))[:3]
        where = "; ".join(
            f"{list(map(int, ix))}: |dp| {diff[tuple(ix)]:.3g}, gradient "
            f"{g_b[k][tuple(ix)]:.4g} (one process) / "
            f"{g_a[k][tuple(ix)]:.4g} (ranks)" for ix in over)
        col = ""
        if g_b[k].ndim == 2:
            dg = np.abs(g_a[k] - g_b[k]).sum(0)
            col = (f"; column {int(dg.argmax())} holds "
                   f"{dg.max() / dg.sum():.3f} of the leaf's |dg|")
        print(f"{label}: Adam moved {n_over} of {name}'s {size} elements "
              f"beyond rtol 2e-4 / atol 1e-6 (not held): {where}{col}")


def run_data_parallel():
    """Phase 26: data-parallel training at full width from the spawned
    ranks of ``parallel/steps.py``: two gloo ranks on cuda:0, a one-rank
    NCCL group, and with two cards or more NCCL over them; Sub_GC_Kar at
    64 images and Full_GC_Kar at 100 (synced GCN BatchNorm), two hoisted
    steps each from iteration 0 with dropout on, and a val pass.  Returns
    (row kernel launches on the ranks' val passes, stats)."""
    import tempfile
    from dataclasses import asdict
    import torch
    from subgc_tpu_torch import build_configs
    from subgc_tpu_torch.parallel import steps as PS
    from subgc_tpu_torch.models.params import init_params_numpy
    specs, cfgs = {}, {}
    for preset, seed in (("Sub_GC_Kar", 90), ("Full_GC_Kar", 91)):
        cfg, tcfg, _ = build_configs(preset, mode="train")
        cfgs[preset] = cfg
        B = tcfg.batch_size
        specs[preset] = dict(
            cfg=asdict(cfg), tcfg=asdict(tcfg), params_seed=0, seed=seed,
            batches=[dp_batch(cfg, B, seed + i) for i in range(2)],
            steps=[None, None], val_batch=dp_batch(cfg, B, seed + 5),
            time=True, grads=True)
    t0 = time.perf_counter()
    single = {k: PS.run_steps(v, "cuda:0") for k, v in specs.items()}
    print(f"data-parallel reference: one process, "
          f"{time.perf_counter() - t0:.1f} s")
    control = {}
    for k, v in specs.items():
        p_np, s_np = init_params_numpy(cfgs[k], seed=0)
        control[k] = PS.run_steps(
            dict(v, params=(PS.one_ulp_away(p_np, seed=5), s_np),
                 val_batch=None, time=False), "cuda:0")
    count = torch.cuda.device_count()
    runs = [("gloo x2 on cuda:0", ["cuda:0"] * 2, "gloo", list(specs)),
            ("nccl x1", ["cuda:0"], "nccl", ["Sub_GC_Kar"])]
    if count >= 2:
        world = 4 if count >= 4 else 2
        runs.append((f"nccl x{world}", [f"cuda:{i}" for i in range(world)],
                     "nccl", list(specs)))
    stats, row_launches = {}, 0
    for label, devices, backend, names in runs:
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            reports = PS.run_ranks([specs[k] for k in names], devices, d,
                                   backend)
            wall = time.perf_counter() - t0
        for i, name in enumerate(names):
            per_spec = [r[i] for r in reports]
            if per_spec[0]["backend"] != backend:
                fail(f"{label}: ranks ran {per_spec[0]['backend']}")
            stats[f"{name} {label}"] = check_ranks(
                f"{name} {label}", per_spec, single[name], control[name],
                cfgs[name])
            row_launches += sum(r["val_launches"]["row"] for r in per_spec)
        print(f"{label}: spawn to join {wall:.1f} s")
    return row_launches, stats


# ---- the published-weights route (phase 27)

PUBLISHED_IMAGES = 16     # 27a: one 16-image dispatch of the test CLI
PUBLISHED_BUCKET = 16     # the synthetic banks' 5 GT + 8 sampled sub-graphs


def reference_weights(cfg, seed):
    """The port's (params, state) from ``init_params_numpy(cfg, seed)``,
    with every BatchNorm scale, bias and running statistic drawn from the
    seed too (scale ~U(0.8, 1.2), bias and mean ~N(0, 0.05), var ~U(0.8,
    1.2)), so that a swapped or dropped BatchNorm leaf shows."""
    from subgc_tpu_torch.models.params import init_params_numpy
    params, state = init_params_numpy(cfg, seed=seed)
    rng = np.random.RandomState(seed + 1)

    def draw(p, s):
        n = p["scale"].shape
        p["scale"] = rng.uniform(0.8, 1.2, n).astype("f")
        p["bias"] = rng.normal(0, 0.05, n).astype("f")
        s["mean"] = rng.normal(0, 0.05, n).astype("f")
        s["var"] = rng.uniform(0.8, 1.2, n).astype("f")

    if cfg.gcn_bn:
        for layer, slayer in zip(params["gcn"], state["gcn_bn"]):
            for unit, sunit in zip(layer, slayer):
                draw(unit["bn"], sunit)
    for i in range(cfg.use_bn):
        draw(params["decoder"][f"att_bn{i}"], state["att_bn"][f"bn{i}"])
    return params, state


def reference_state_dict(params, state, cfg):
    """The reference ``TopDownModel``'s state_dict holding the port's
    (params, state): its key names, torch's ``[out, in]`` Linear and
    ``[4H, in]`` LSTMCell layouts, ``att_embed``'s index shift under
    ``use_bn`` and each BatchNorm's ``num_batches_tracked`` counter (the
    inverse of ``cli/convert_ckpt.py::torch_state_dict_to_params``)."""
    import torch
    sd = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    def lin(name, p):
        sd[name + ".weight"], sd[name + ".bias"] = t(p["w"].T), t(p["b"])

    def lstm(name, p):
        sd[name + ".weight_ih"] = t(p["w_ih"].T)
        sd[name + ".weight_hh"] = t(p["w_hh"].T)
        sd[name + ".bias_ih"], sd[name + ".bias_hh"] = t(p["b_ih"]), t(p["b_hh"])

    def bn(name, p, s):
        sd[name + ".weight"], sd[name + ".bias"] = t(p["scale"]), t(p["bias"])
        sd[name + ".running_mean"] = t(s["mean"])
        sd[name + ".running_var"] = t(s["var"])
        sd[name + ".num_batches_tracked"] = torch.tensor(60000)

    fusion = params["fusion"]
    lin("obj_v_proj", fusion["obj_v_proj"])
    if cfg.noun_fuse:
        sd["sg_obj_embed.weight"] = t(fusion["obj_emb"])
        lin("obj_emb_proj", fusion["obj_emb_proj"])
    sd["sg_pred_embed.weight"] = t(fusion["pred_emb"])
    lin("pred_emb_prj", fusion["pred_emb_proj"])
    for i, layer in enumerate(params["gcn"]):
        for u, unit in enumerate(layer):
            pre = f"gcn_backbone.gcn.{i}.gcn_collect.collect_units.{u}"
            lin(pre + ".fc_lft", unit["lft"])
            lin(pre + ".fc_rgt", unit["rgt"])
            if cfg.gcn_bn:
                bn(pre + ".bn", unit["bn"], state["gcn_bn"][i][u])
    if cfg.use_gpn:
        gpn = params["gpn"]
        if not cfg.use_gt_subg:
            lin("gpn_layer.gpn_fc.0", gpn["fc1"])
            lin("gpn_layer.gpn_fc.3", gpn["fc2"])
        lin("gpn_layer.read_out_proj.0", gpn["readout1"])
        lin("gpn_layer.read_out_proj.1", gpn["readout2"])
    else:
        lin("read_out_proj.0", params["readout"]["readout1"])
        lin("read_out_proj.1", params["readout"]["readout2"])
    dec = params["decoder"]
    sd["embed.0.weight"] = t(dec["embed"])
    lin("fc_embed.0", dec["fc_embed1"])
    lin("fc_embed.2", dec["fc_embed2"])
    lin(f"att_embed.{1 if cfg.use_bn else 0}", dec["att_embed"])
    if cfg.use_bn:
        bn("att_embed.0", dec["att_bn0"], state["att_bn"]["bn0"])
    if cfg.use_bn == 2:
        bn("att_embed.4", dec["att_bn1"], state["att_bn"]["bn1"])
    lin("ctx2att", dec["ctx2att"])
    lstm("core.att_lstm", dec["att_lstm"])
    lstm("core.lang_lstm", dec["lang_lstm"])
    lin("core.attention.h2att", dec["h2att"])
    lin("core.attention.alpha_net", dec["alpha_net"])
    lin("logit", dec["logit"])
    return sd


def reference_infos(cfg, vocab, run_id="topdown", iteration=60000, epoch=30):
    """A reference ``infos_*.pkl``'s contents: its ``opt`` namespace (the
    model fields with the reference's 0/1 flags, beside train and data
    options the converter must not read), ``vocab``, ``iter`` and
    ``epoch``."""
    import argparse
    opt = argparse.Namespace(
        id=run_id, caption_model="topdown", input_json="data/cocotalk.json",
        batch_size=64, learning_rate=5e-4, max_length=cfg.seq_length,
        vocab_size=cfg.vocab_size, seq_length=cfg.seq_length,
        input_encoding_size=cfg.input_encoding_size, rnn_size=cfg.rnn_size,
        num_layers=cfg.num_layers, att_hid_size=cfg.att_hid_size,
        fc_feat_size=cfg.fc_feat_size, att_feat_size=cfg.att_feat_size,
        drop_prob_lm=cfg.drop_prob_lm, use_bn=cfg.use_bn,
        embed_dim=cfg.embed_dim, gcn_dim=cfg.gcn_dim,
        gcn_layers=cfg.gcn_layers, gcn_residual=cfg.gcn_residual,
        gcn_bn=int(cfg.gcn_bn), noun_fuse=int(cfg.noun_fuse),
        pred_emb_type=cfg.pred_emb_type, use_gpn=int(cfg.use_gpn),
        use_gt_subg=int(cfg.use_gt_subg), obj_num=cfg.obj_num,
        rel_num=cfg.rel_num)
    return {"opt": opt, "vocab": dict(vocab), "iter": iteration,
            "epoch": epoch}


def write_reference_checkpoint(workdir, cfg, vocab, seed, run_id="topdown"):
    """``model-60000.pth`` + ``infos_<run_id>-60000.pkl`` of the seeded
    reference weights in ``workdir``.  Returns (pth, infos path, params,
    state): the numpy trees the conversion must give back bitwise."""
    import pickle
    import torch
    params, state = reference_weights(cfg, seed)
    pth = os.path.join(workdir, "model-60000.pth")
    torch.save(reference_state_dict(params, state, cfg), pth)
    infos = os.path.join(workdir, f"infos_{run_id}-60000.pkl")
    with open(infos, "wb") as f:
        pickle.dump(reference_infos(cfg, vocab, run_id), f)
    return pth, infos, params, state


def same_leaves(label, got, want):
    """Every leaf of the numpy tree ``want`` equals ``got``'s bitwise."""
    from subgc_tpu_torch.models.params import _flatten, params_to_numpy
    g, w = _flatten(params_to_numpy(got)), _flatten(want)
    if sorted(g) != sorted(w):
        fail(f"{label}: leaves differ: {sorted(set(g) ^ set(w))[:8]}")
    bad = [k for k in w if g[k].dtype != w[k].dtype
           or g[k].tobytes() != w[k].tobytes()]
    if bad:
        fail(f"{label}: {len(bad)} leaves differ from the seeded arrays, "
             f"first {bad[:4]}")
    return len(w)


def convert_and_setup(label, workdir, cfg, vocab, seed, model_type, man,
                      device):
    """The published-weights route up to the model: a seeded
    reference-layout ``.pth`` + infos pickle, ``cli/convert_ckpt.py --pth
    --infos --out``, then ``setup(start_from=, device=)`` with the class
    names of the dataset ``man``, whose params and state must equal the
    seeded arrays bitwise.  Returns (checkpoint directory, params, state,
    stats)."""
    from subgc_tpu_torch import DataConfig, config_from_json, setup
    from subgc_tpu_torch.cli import convert_ckpt
    from subgc_tpu_torch.config import ModelConfig
    os.makedirs(workdir, exist_ok=True)
    pth, infos, params_np, state_np = write_reference_checkpoint(
        workdir, cfg, vocab, seed)
    out = os.path.join(workdir, "converted")
    t0 = time.perf_counter()
    convert_ckpt.main(["--pth", pth, "--infos", infos, "--out", out,
                       "--model_type", model_type])
    convert_s = time.perf_counter() - t0
    with open(os.path.join(out, "infos.json")) as f:
        written = json.load(f)
    mcfg = config_from_json(ModelConfig, written["model_config"])
    if any(getattr(mcfg, k) != getattr(cfg, k)
           for k in convert_ckpt._OPT_TO_MCFG) or \
            written["iter"] != 60000 or written["vocab"] != dict(vocab):
        fail(f"{label}: infos.json does not carry the reference's config, "
             f"iteration and vocab")
    dcfg = DataConfig(obj_name_path=man["obj_name_path"],
                      rel_name_path=man["rel_name_path"])
    params, state = setup(mcfg, dcfg, start_from=out, device=device)
    n = same_leaves(f"{label} params", params, params_np)
    n += same_leaves(f"{label} state", state, state_np)
    stats = {"convert_s": convert_s,
             "pth_mib": os.path.getsize(pth) / 2**20,
             "checkpoint_mib": os.path.getsize(
                 os.path.join(out, "model.npz")) / 2**20,
             "leaves": n}
    print(f"{label}: converted {stats['pth_mib']:.1f} MiB .pth in "
          f"{convert_s:.2f} s -> {stats['checkpoint_mib']:.1f} MiB "
          f"model.npz; setup(start_from=) on {device}: {n} leaves equal "
          f"the seeded arrays bitwise")
    return out, params, state, stats


def published_dataset(workdir, cfg, seed):
    """A synthetic dataset at the model's widths (vocab, classes, 2048-d
    features) with ``PUBLISHED_IMAGES`` test images, its label file an
    npz, read without h5py."""
    from subgc_tpu_torch.data.synthetic import generate_dataset
    return generate_dataset(
        os.path.join(workdir, "data"), n_images=5 * PUBLISHED_IMAGES,
        vocab_size=cfg.vocab_size, n_obj_classes=cfg.num_obj_classes,
        n_rel_classes=cfg.num_rel_classes, feat_dim=cfg.att_feat_size,
        seed=seed, label_format="npz")


def run_test_cli(ckpt, man, device, tag):
    """The port's ``cli/test.py`` main on the dataset's test split; returns
    (predictions, run_test_split's wall s, captions)."""
    from subgc_tpu_torch.cli import test as test_cli
    from subgc_tpu_torch.eval import runner
    timed = {}
    inner = runner.run_test_split

    def record(*a, **k):
        out = inner(*a, **k)
        timed.update(wall=out[1], n_caps=out[2])
        return out

    runner.run_test_split = record
    try:
        res = test_cli.main([
            "Sub_GC_Kar", "--checkpoint_path", ckpt, "--device", device,
            "--iter_tag", tag, "--batch_images", str(PUBLISHED_IMAGES),
            "--bucket", str(PUBLISHED_BUCKET),
            "--input_json", man["input_json"],
            "--input_label_h5", man["input_label_h5"],
            "--sg_dir", man["sg_dir"], "--mask_dir", man["mask_dir"]])
    finally:
        runner.run_test_split = inner
    preds = np.load(res["captions_path"], allow_pickle=True).tolist()
    return preds, timed["wall"], timed["n_caps"]


def run_published(workdir, device="cuda"):
    """Phase 27: the published-weights route on the card.  27a Sub_GC_Kar
    and 27b Full_GC_Kar at ``ModelConfig()`` widths from seeded
    reference-layout checkpoints through ``cli/convert_ckpt.py`` and
    ``setup``; 27c ``cli/quickstart.py``.  Returns (the beam-shared
    kernel's launches, its checks, stats)."""
    import torch
    from subgc_tpu_torch import build_configs, decode_sequence, setup
    from subgc_tpu_torch.cli import quickstart
    from subgc_tpu_torch.ops import attention as A
    stats = {}

    # ---- 27a. Sub_GC_Kar through the test CLI, card then CPU
    cfg, ecfg, _ = build_configs("Sub_GC_Kar")
    man = published_dataset(os.path.join(workdir, "kar"), cfg, seed=27)
    with open(man["input_json"]) as f:
        vocab = json.load(f)["ix_to_word"]
    ckpt, params, _, stats["kar"] = convert_and_setup(
        "27a Sub_GC_Kar", os.path.join(workdir, "kar"), cfg, vocab, 70,
        "Sub_GC_Kar", man, device)
    S = PUBLISHED_IMAGES * ecfg.gpn_max_subg
    kar_check = check_attention(params, "image", S, PUBLISHED_IMAGES,
                                seed=71)
    del params
    run_test_cli(ckpt, man, device, "warmup")
    torch.cuda.synchronize()
    A.LAUNCHES = A.ROW_LAUNCHES = A.PROJECT_LAUNCHES = 0
    reset_gemm()
    preds, wall, n_caps = run_test_cli(ckpt, man, device, "card")
    launches = A.LAUNCHES
    check_gemm_launches("27a", dispatch_rows(preds, PUBLISHED_IMAGES,
                                             ecfg.beam_size,
                                             ecfg.gpn_max_subg),
                        cfg.seq_length)
    if launches != cfg.seq_length or A.ROW_LAUNCHES:
        fail(f"27a: beam-shared kernel launched {launches} times, row "
             f"kernel {A.ROW_LAUNCHES}; expected 1 dispatch x "
             f"{cfg.seq_length} steps and 0")
    check_project_launches("27a", launches)
    check_predictions(preds, PUBLISHED_IMAGES, ecfg.gpn_max_subg,
                      bucket=PUBLISHED_BUCKET)
    t0 = time.perf_counter()
    cpu_preds, _, _ = run_test_cli(ckpt, man, "cpu", "cpu")
    n_same, n_total = compare_card_cpu(preds, cpu_preds)
    if n_same < 0.95 * n_total:
        fail(f"27a: only {n_same}/{n_total} captions agree between card and "
             f"cpu")
    stats["kar"].update(captions=n_caps, decode_s=wall,
                        captions_per_s=n_caps / wall, launches=launches,
                        card_cpu_same=[n_same, n_total])
    print(f"27a Sub_GC_Kar from the converted checkpoint: cli/test.py on "
          f"{PUBLISHED_IMAGES} images, {n_caps} captions in {wall:.3f} s = "
          f"{n_caps / wall:.1f} captions/s; beam-shared kernel launches "
          f"{launches}; card vs cpu ({time.perf_counter() - t0:.1f} s): "
          f"{n_same}/{n_total} captions identical, keep sets identical")

    # ---- 27b. Full_GC_Kar (GCN BatchNorm keys), one image, S=1, B=3
    cfg, ecfg, _ = build_configs("Full_GC_Kar")
    vocab = {str(i): f"w{i}" for i in range(1, cfg.vocab_size + 1)}
    ckpt, params, state, stats["fullgc"] = convert_and_setup(
        "27b Full_GC_Kar", os.path.join(workdir, "fullgc"), cfg, vocab, 72,
        "Full_GC_Kar", man, device)
    fullgc_check = check_attention(params, "subgraph", 1, 1, seed=73,
                                   beams=ecfg.beam_size)
    examples = make_examples(cfg, 1, 1, seed=74)
    decode_fullgc(params, state, examples, cfg, ecfg, device)    # warm-up
    torch.cuda.synchronize()
    A.LAUNCHES = A.ROW_LAUNCHES = A.PROJECT_LAUNCHES = 0
    reset_gemm()
    seqs = decode_fullgc(params, state, examples, cfg, ecfg, device)
    fullgc_launches = A.LAUNCHES
    check_gemm_launches("27b", ecfg.beam_size, cfg.seq_length)
    if fullgc_launches != cfg.seq_length or A.ROW_LAUNCHES:
        fail(f"27b: beam-shared kernel launched {fullgc_launches} times, "
             f"row kernel {A.ROW_LAUNCHES}; expected {cfg.seq_length} and 0")
    check_project_launches("27b", fullgc_launches)
    cpu = decode_fullgc(*setup(cfg, start_from=ckpt, device="cpu"),
                        examples, cfg, ecfg, torch.device("cpu"))
    caps, cpu_caps = decode_sequence(vocab, seqs), decode_sequence(vocab, cpu)
    if caps != cpu_caps:
        fail(f"27b: card caption {caps} against cpu {cpu_caps}")
    stats["fullgc"].update(launches=fullgc_launches, caption=caps[0])
    print(f"27b Full_GC_Kar from the converted checkpoint: beam "
          f"{ecfg.beam_size}, beam-shared kernel launches "
          f"{fullgc_launches}; card and cpu captions identical: {caps[0]!r}")
    del params, state

    # ---- 27c. the quickstart walkthrough on the card
    t0 = time.perf_counter()
    qs = quickstart.main([os.path.join(workdir, "quickstart"),
                          "--device", device])
    if not (qs["scores"] and qs["rerank_ind"] and qs["top1"]):
        fail("27c: the quickstart returned no scores or no rerank")
    stats["quickstart_s"] = time.perf_counter() - t0
    print(f"27c cli/quickstart.py on {device}: ran to its end in "
          f"{stats['quickstart_s']:.1f} s")
    return launches + fullgc_launches, [kar_check, fullgc_check], stats


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
    from subgc_tpu_torch.ops import gemm as GM
    from subgc_tpu_torch.ops import sgpn as SG

    # ---- 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi unavailable"
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 matmuls sum in float32, as the JAX package's do (the port's entry
    # points set it too; this covers the phases that call modules directly)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
    _build.load("gemm")             # the split-TF32 decode products
    for line in _build.BUILD_INFO["gemm"]["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas (gemm):", line.strip())
    _build.load("sgpn")             # the sGPN read-out max and NMS
    for line in _build.BUILD_INFO["sgpn"]["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas (sgpn):", line.strip())

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

    # ---- 28. the split-TF32 decode products at both test cells' shapes
    gemm_rows, gemm_sweep, gemm_prep = run_split_gemm(params, cfg)
    print(json.dumps({"split_gemm": gemm_rows, "sweep": gemm_sweep,
                      "preparation": gemm_prep}))

    # ---- 30. the sGPN test path's kernels at a test dispatch's shapes
    sgpn = run_sgpn(params, cfg)
    print(json.dumps({"sgpn": sgpn}))

    # ---- 4. main path at full width
    examples = make_examples(cfg, N_IMAGES, BUCKET)
    loader = MemoryLoader(examples)
    vocab = {str(i): f"w{i}" for i in range(1, cfg.vocab_size + 1)}
    run_test_split(params, state, loader, cfg, ecfg, vocab,
                   num_images=BATCH_IMAGES, verbose=False,
                   batch_images=BATCH_IMAGES, device="cuda")    # warm-up
    torch.cuda.synchronize()
    A.LAUNCHES = A.ROW_LAUNCHES = A.PROJECT_LAUNCHES = 0
    reset_gemm()
    SG.reset_launch_counts()
    preds, wall, n_caps = run_test_split(
        params, state, loader, cfg, ecfg, vocab, verbose=False,
        batch_images=BATCH_IMAGES, device="cuda")
    launches = A.LAUNCHES
    n_dispatch = -(-N_IMAGES // BATCH_IMAGES)
    sgpn_launches = (SG.READOUT_LAUNCHES, SG.NMS_LAUNCHES)
    if sgpn_launches != (n_dispatch, n_dispatch):
        fail(f"sGPN kernels launched {sgpn_launches} times (read-out, NMS) "
             f"on the main path, expected once each a dispatch "
             f"({n_dispatch})")
    check_gemm_launches("main path",
                        dispatch_rows(preds, BATCH_IMAGES, ecfg.beam_size,
                                      ecfg.gpn_max_subg),
                        cfg.seq_length)
    if launches != n_dispatch * cfg.seq_length or A.ROW_LAUNCHES:
        fail(f"attention kernel launched {launches} times on the main path "
             f"(row kernel {A.ROW_LAUNCHES}), expected {n_dispatch} "
             f"dispatches x {cfg.seq_length} steps (and 0)")
    check_project_launches("main path", launches)
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

    # ---- 29. the beam search from captured CUDA graphs against eager
    print(json.dumps({"graphs": run_graphs(params, state, examples, cfg,
                                           ecfg)}))

    # ---- 6. the per-row kernel; the beam-shared kernel at one beam
    row_checks = [check_row_attention(params, S_main, seed=5),
                  check_row_attention(params, 96 * keep, seed=6)]
    checks.append(check_attention(params, "image", 2000, 2, seed=4, beams=1))
    projections = [check_projection(params, Q, seed=10 + i)
                   for i, Q in enumerate((S_main * 2, 2000, S_main))]
    print(json.dumps({"projection_stage": [
        {"Q": Q, **p} for Q, p in zip((S_main * 2, 2000, S_main),
                                      projections)]}))

    # ---- 7-9. grounding, fan-out and top-k paths
    grd_launches = run_grounding(params, cpu_params, state, examples, vocab)
    fan_launches, greedy_preds, fan_examples = run_fanout(
        params, cpu_params, state, vocab)
    run_topk(params, state, vocab, fan_examples, greedy_preds)

    # ---- 10-13. 3 beams; Full_GC_Kar; the controllability presets
    checks += [check_attention(params, "subgraph", S, S, seed=20 + S,
                               beams=3) for S in (1, 32)]
    fullgc_launches = run_fullgc(vocab)
    ctl_launches, ctl_preds = run_sct("Sub_GC_Flickr_CTL", params_np, state,
                                      vocab, seed=21)
    sup_cfg, _, _ = build_configs("Sub_GC_Sup_Flickr_CTL")
    sup_launches, _ = run_sct("Sub_GC_Sup_Flickr_CTL",
                              *init_params_numpy(sup_cfg, seed=1), vocab,
                              seed=22)
    ctl_check = check_attention(params, "image", BATCH_IMAGES * SCT_BUCKET,
                                BATCH_IMAGES, seed=30)
    checks.append(ctl_check)

    # ---- 13a-13d. the evaluation layer on the captions decoded above
    eval_stats = run_eval(preds, cpu_preds, greedy_preds, ctl_preds, vocab)
    print(json.dumps({"eval": eval_stats}))

    # ---- 17-19. the bf16 chain at test time, while the test params are on
    # the card: both bf16 kernels alone, Sub_GC_Kar and Sub_GC_Flickr_GRD
    _, tcfg, _ = build_configs("Sub_GC_Kar", mode="train")
    S_val = tcfg.seq_per_img * tcfg.batch_size
    bf16_shared, bf16_row, _ = run_bf16_kernels(params, S_main, S_val,
                                                card)
    bf16_launches, bf16_test = run_bf16_test(params, cpu_params, state,
                                             examples, vocab, preds)
    bf16_grd_launches = run_bf16_grounding(params, cpu_params, state,
                                           examples, vocab)

    # ---- 23. diverse beam groups, float32 and bf16
    div_launches, div_stats, div_checks = run_diverse(
        params, cpu_params, state, examples, vocab)
    print(json.dumps({"diverse": div_stats}))

    # ---- 25. sharded decode (image and sub-graph axes), --shard_fanout
    # serving, and with two cards a launch on the second from the first
    shard_launches, shard_checks, shard_stats = run_sharded(
        params, params_np, state, examples, preds, fan_examples,
        greedy_preds, vocab)
    checks += shard_checks
    print(json.dumps({"sharded": shard_stats,
                      "shard_attention": dict(zip(
                          ("kar_image_shard", "mrnn_chunk_S500"),
                          shard_checks))}))

    # ---- 21. serving over HTTP: both kernels alone at its dispatch's
    # shapes (8 images x keep 10 rows of 2 beams), then the server
    serve_rows = SERVE_BATCH * keep
    serve_f32_check = check_attention(params, "subgraph", serve_rows,
                                      serve_rows, seed=62)
    serve_bf16_check = check_attention(params, "image", serve_rows,
                                       SERVE_BATCH, seed=63, bf16=True)
    checks.append(serve_f32_check)
    serve_f32, serve_bf16, serve_stats = run_serving(params_np, state,
                                                     examples, vocab)
    print(json.dumps({"serving": serve_stats,
                      "serve_shared_attention": serve_f32_check,
                      "serve_shared_attention_bf16": serve_bf16_check}))

    # ---- 14-16. training; first both kernels at the val passes' shapes
    val_row_check = check_row_attention(params, S_val, seed=40)
    val_shared_check = check_attention(params, "image", S_val,
                                       tcfg.batch_size, seed=41, beams=1)
    row_checks.append(val_row_check)
    checks.append(val_shared_check)
    del params       # the training phases read their own peak memory
    val_row, val_shared, train_stats = run_train(params_np, state)
    print(json.dumps({"train": train_stats, "ctl_attention": ctl_check,
                      "val_row_attention": val_row_check,
                      "val_shared_attention": val_shared_check}))
    # ---- 20. bf16 training
    bf16_val_row, bf16_train = run_bf16_train(params_np, state)
    # ---- 22. SCST and the four other optimizers
    scst_row, scst_row_bf16, scst_stats = run_scst(params_np, state)
    print(json.dumps({"scst": scst_stats}))
    # ---- 24. the host library and the input path
    print(json.dumps({"host": run_host(preds, params_np, state)}))
    # ---- 26. data-parallel training in spawned ranks
    dp_row, dp_stats = run_data_parallel()
    print(json.dumps({"data_parallel": dp_stats}))
    # ---- 27. the published-weights route: converted reference checkpoints
    # through setup and the test CLI, then the quickstart
    import tempfile
    with tempfile.TemporaryDirectory() as workdir:
        pub_launches, pub_checks, pub_stats = run_published(workdir)
    checks += pub_checks
    print(json.dumps({"published": pub_stats, "published_attention": dict(
        zip(("kar_image_S160", "fullgc_S1_B3"), pub_checks)), "card": card}))
    print(json.dumps({"bf16": {
        "test": bf16_test, "train": bf16_train,
        "shared_attention_bf16": dict(zip(
            ("kar_image_S160", "kar_subgraph_S160", "fanout_S2000",
             "fullgc_S1_B3"), bf16_shared)),
        "row_attention_bf16": dict(zip(("grd_R160", "val_R320"),
                                       bf16_row))}}))

    kernels = [{
        "name": "shared_attention",
        "route": "cuda",
        "source": "subgc_tpu_torch/ops/csrc/attention.cu",
        "replaces": "subgc_tpu/ops/pallas_attention.py:75",
        "launches": (launches + fan_launches + fullgc_launches
                     + ctl_launches + sup_launches + val_shared
                     + serve_f32 + div_launches["float32"]
                     + shard_launches + pub_launches),
        "max_abs_err": max(c["max_abs_err"]
                           for c in checks + [div_checks["float32"]]),
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
        "launches": grd_launches + val_row + scst_row + dp_row,
        "max_abs_err": max(c["max_abs_err"] for c in row_checks),
        "ms": row_checks[0]["ms"],
        "plain_ms": row_checks[0]["plain_ms"],
        "bound_ms": row_checks[0]["bound_ms"],
        "bound_by": row_checks[0]["bound_by"],
        "library_ms": None,
    }, {
        "name": "shared_attention_bf16",
        "route": "cuda",
        "source": "subgc_tpu_torch/ops/csrc/attention.cu",
        "replaces": "subgc_tpu/ops/pallas_attention.py:75",
        "launches": bf16_launches + serve_bf16 + div_launches["bfloat16"],
        "max_abs_err": max(c["max_abs_err"]
                           for c in bf16_shared + [serve_bf16_check,
                                                   div_checks["bfloat16"]]),
        "ms": bf16_shared[0]["ms"],
        "plain_ms": bf16_shared[0]["plain_ms"],
        "bound_ms": bf16_shared[0]["bound_ms"],
        "bound_by": bf16_shared[0]["bound_by"],
        "library_ms": None,
    }, {
        "name": "row_attention_bf16",
        "route": "cuda",
        "source": "subgc_tpu_torch/ops/csrc/attention.cu",
        "replaces": "subgc_tpu/ops/pallas_attention.py:29",
        "launches": bf16_grd_launches + bf16_val_row + scst_row_bf16,
        "max_abs_err": max(c["max_abs_err"] for c in bf16_row),
        "ms": bf16_row[0]["ms"],
        "plain_ms": bf16_row[0]["plain_ms"],
        "bound_ms": bf16_row[0]["bound_ms"],
        "bound_by": bf16_row[0]["bound_by"],
        "library_ms": None,
    }, {
        "name": "split_gemm",
        "route": "cuda",
        "source": "subgc_tpu_torch/ops/csrc/gemm.cu",
        "replaces": None,
        # the fan-out path's: the one checked path whose decode takes it
        "launches": GEMM_COUNTS["fan-out path"],
        "max_abs_err": max(r["max_abs_err"] for r in gemm_rows),
        "ms": gemm_rows[0]["ms"],
        "plain_ms": gemm_rows[0]["plain_ms"],
        "bound_ms": gemm_rows[0]["bound_ms"],
        "bound_by": gemm_rows[0]["bound_by"],
        "library_ms": gemm_rows[0]["library_ms"],
    }, {
        "name": "split_tf32_weight_prep",
        "route": "cuda",
        "source": "subgc_tpu_torch/ops/csrc/gemm.cu",
        "replaces": None,
        # the fan-out path's preparations; ms, plain_ms and bound_ms are a
        # decode call's seven, the bound their bytes at HBM_RATE
        "launches": GEMM_PREPS["fan-out path"],
        "max_abs_err": 0.0,
        "ms": gemm_prep["ms"],
        "plain_ms": gemm_prep["plain_ms"],
        "bound_ms": gemm_prep["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "readout_max",
        "route": "cuda",
        "source": "subgc_tpu_torch/ops/csrc/sgpn.cu",
        "replaces": None,
        # the main path's (phase 4): one a dispatch; ms at a test
        # dispatch's shapes, the torch path's masked broadcast beside it
        "launches": sgpn_launches[0],
        "max_abs_err": 0.0,
        "ms": sgpn["readout_max"]["ms"],
        "plain_ms": sgpn["readout_max"]["torch_path_ms"],
        "bound_ms": sgpn["readout_max"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "subgraph_nms",
        "route": "cuda",
        "source": "subgc_tpu_torch/ops/csrc/sgpn.cu",
        "replaces": None,
        # ms at kar_test's threshold and keep; plain_ms the torch route's
        # subgraph_nms (the fixpoint with its host-synced rounds)
        "launches": sgpn_launches[1],
        "max_abs_err": 0.0,
        "ms": sgpn["subgraph_nms"]["sub_gc.kar_test"]["ms"],
        "plain_ms": sgpn["subgraph_nms"]["sub_gc.kar_test"]["torch_nms_ms"],
        "bound_ms": sgpn["subgraph_nms"]["sub_gc.kar_test"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
