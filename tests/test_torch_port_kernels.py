"""The port's CUDA kernels against their plain versions, and the wrappers'
checks.

This file imports neither jax nor the JAX package, so the ``cuda`` tests run
on a GPU machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_port_kernels.py

Without a card those tests skip; the wrapper's input checks run anywhere.
Kernel against plain: weights within atol 1e-5, att_res within rtol 1e-4 /
atol 1e-4, the projection stage alone within rtol / atol 1e-5 (float32
summation order).
"""
import threading

import numpy as np
import pytest
import torch

from subgc_tpu_torch.ops import attention as A


def _inputs(layout, S=37, B=2, G=5, n=37, R=64, H=32, D=64, seed=0):
    rng = np.random.RandomState(seed)
    rows = G if layout == "image" else S
    mask = (rng.rand(S, n) > 0.6).astype("f")
    mask[:, 0] = 1.0
    idx = (np.repeat(np.arange(G), -(-S // G))[:S] if layout == "image"
           else np.arange(S))
    bound = 1.0 / np.sqrt(R)
    arrays = [rng.uniform(-1, 1, (S, B, R)), rng.randn(rows, n, H),
              rng.rand(rows, n, D), mask, idx,
              rng.uniform(-bound, bound, (R, H)),
              rng.uniform(-bound, bound, (H,)), rng.uniform(-0.2, 0.2, (H, 1)),
              rng.uniform(-0.2, 0.2, (1,))]
    out = [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]
    out[4] = torch.from_numpy(idx.astype(np.int32))
    return out


def test_check_accepts_matching_inputs():
    assert A._check(*_inputs("image")) == (37, 2, 64, 5, 37, 32, 64)


@pytest.mark.parametrize("bad", ["shape", "dtype", "idx_dtype", "beams"])
def test_check_rejects_what_the_kernel_does_not_take(bad):
    x = _inputs("subgraph", B=5 if bad == "beams" else 2)
    if bad == "shape":
        x[3] = x[3][:, :-1]                     # mask narrower than p_att
    elif bad == "dtype":
        x[2] = x[2].double()
    elif bad == "idx_dtype":
        x[4] = x[4].long()
    with pytest.raises((ValueError, TypeError)):
        A._check(*x)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["image", "subgraph"])
@pytest.mark.parametrize("beams", [1, 2, 3, 4])
def test_kernel_matches_plain_on_card(layout, beams):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    x = [t.cuda() for t in _inputs(layout, B=beams, seed=beams)]
    before = A.LAUNCHES
    out, w = A.shared_attention(*x)
    torch.cuda.synchronize()
    assert A.LAUNCHES == before + 1
    r_out, r_w = A.shared_attention_ref(*x)
    torch.testing.assert_close(w, r_w, rtol=0, atol=1e-5)
    torch.testing.assert_close(out, r_out, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_kernel_all_zero_mask_gives_nan_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    x = [t.cuda() for t in _inputs("image")]
    x[3][1] = 0.0
    _, w = A.shared_attention(*x)
    assert torch.isnan(w[1]).all() and torch.isfinite(w[0]).all()


def _row_inputs(R=9, n=37, Hin=64, H=32, D=64, seed=0):
    rng = np.random.RandomState(seed)
    count = rng.randint(2, n, (R, 1))
    bound = 1.0 / np.sqrt(Hin)
    arrays = [rng.uniform(-1, 1, (R, Hin)), rng.randn(R, n, H),
              rng.rand(R, n, D), np.arange(n)[None] < count,
              rng.uniform(-bound, bound, (Hin, H)),
              rng.uniform(-bound, bound, (H,)), rng.uniform(-0.2, 0.2, (H, 1)),
              rng.uniform(-0.2, 0.2, (1,))]
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


def test_row_check_accepts_matching_inputs():
    assert A._check_rows(*_row_inputs()) == (9, 64, 37, 32, 64)


@pytest.mark.parametrize("bad", ["mask_shape", "wh_shape", "h_rank",
                                 "dtype", "bias_dtype"])
def test_row_check_rejects_what_the_kernel_does_not_take(bad):
    x = _row_inputs()
    if bad == "mask_shape":
        x[3] = x[3][:, :-1]
    elif bad == "wh_shape":
        x[4] = x[4][:-1]
    elif bad == "h_rank":
        x[0] = x[0][:, None]
    elif bad == "dtype":
        x[1] = x[1].half()
    elif bad == "bias_dtype":
        x[7] = x[7].double()
    with pytest.raises((ValueError, TypeError)):
        A._check_rows(*x)


def test_row_wrapper_on_cpu_is_plain_and_uncounted():
    x = _row_inputs(seed=1)
    before = A.ROW_LAUNCHES
    out, w = A.row_attention(*x)
    assert A.ROW_LAUNCHES == before
    r_out, r_w = A.row_attention_ref(*x)
    # two calls of the CPU matmul need not give the same bits on every
    # machine, so the plain path is held to float32 rounding
    torch.testing.assert_close(out, r_out, rtol=0, atol=1e-6)
    torch.testing.assert_close(w, r_w, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    dict(R=1), dict(R=9), dict(R=160, Hin=1000, H=512, D=1000),
    dict(R=37, Hin=130, H=50, D=70),      # H, D not multiples of 4
    dict(R=300, Hin=96, H=200, D=128)])
def test_row_kernel_matches_plain_on_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    x = [t.cuda() for t in _row_inputs(seed=shape["R"], **shape)]
    before = A.ROW_LAUNCHES
    out, w = A.row_attention(*x)
    torch.cuda.synchronize()
    assert A.ROW_LAUNCHES == before + 1
    r_out, r_w = A.row_attention_ref(*x)
    torch.testing.assert_close(w, r_w, rtol=0, atol=1e-5)
    torch.testing.assert_close(out, r_out, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_row_kernel_all_zero_mask_gives_nan_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    x = [t.cuda() for t in _row_inputs()]
    x[3][2] = 0.0
    _, w = A.row_attention(*x)
    assert torch.isnan(w[2]).all() and torch.isfinite(w[0]).all()


@pytest.mark.cuda
def test_row_kernel_rejects_non_contiguous_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    x = [t.cuda() for t in _row_inputs()]
    x[2] = x[2].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        A.row_attention(*x)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


def _project_inputs(Q, Hin, H, seed=0):
    rng = np.random.RandomState(seed)
    bound = 1.0 / np.sqrt(Hin)
    arrays = [rng.uniform(-1, 1, (Q, Hin)),
              rng.uniform(-bound, bound, (Hin, H)),
              rng.uniform(-bound, bound, (H,))]
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


# every tile edge: Q off a multiple of bm, H off bn (and off 4: 4-byte
# copies), Hin off the 16-k slice (and off 4); split on and off
@pytest.mark.cuda
@pytest.mark.parametrize("Q,Hin,H,knobs", [
    (1, 64, 32, {}),
    (37, 130, 50, {}),
    (37, 130, 50, dict(splits=3)),
    (200, 1000, 512, dict(splits=1)),
    (200, 1000, 512, dict(splits=5)),
    (130, 1000, 200, dict(bm=128, bn=128)),
    (70, 18, 130, dict(bm=32, bn=128, splits=2)),
    (320, 1000, 512, {}),
])
def test_project_kernel_matches_plain_on_card(Q, Hin, H, knobs):
    _cuda()
    x = [t.cuda() for t in _project_inputs(Q, Hin, H, seed=Q)]
    plan = A.project_plan(Q, Hin, H, **knobs)
    before = A.PROJECT_LAUNCHES
    ah = A.run_attention_project(*x, plan)
    torch.cuda.synchronize()
    assert A.PROJECT_LAUNCHES == before + 1
    torch.testing.assert_close(ah, A.attention_project_ref(*x), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["image", "subgraph"])
@pytest.mark.parametrize("knobs", [
    dict(splits=1), dict(splits=4), dict(bm=32, bn=128, splits=2),
    dict(rows_per_block=2), dict(rows_per_block=4)])
def test_kernel_plans_match_plain_on_card(layout, knobs):
    """Split on and off, other tiles, several rows per block (in the
    per-sub-graph layout each row of a block is a run of its own)."""
    _cuda()
    x = [t.cuda() for t in _inputs(layout, S=41, B=2, G=5, R=130, H=52,
                                   D=68, seed=len(knobs))]
    knobs = dict(knobs)
    rpb = knobs.pop("rows_per_block", 1)
    plan = A.project_plan(82, 130, 52, **knobs)._replace(rows_per_block=rpb)
    out, w = A.run_shared_attention(x, plan)
    r_out, r_w = A.shared_attention_ref(*x)
    torch.testing.assert_close(w, r_w, rtol=0, atol=1e-5)
    torch.testing.assert_close(out, r_out, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("rpb", [None, 16])
def test_kernel_image_shared_fanout_narrow_on_card(rpb):
    """The greedy fan-out's layout at narrow widths: S=600 rows over G=2
    images, one beam."""
    _cuda()
    x = [t.cuda() for t in _inputs("image", S=600, B=1, G=2, R=64, H=32,
                                   D=64, seed=7)]
    if rpb is None:
        out, w = A.shared_attention(*x)
    else:
        plan = A.attention_plan(600, 1, 2, 64, 32)._replace(
            rows_per_block=rpb)
        out, w = A.run_shared_attention(x, plan)
    r_out, r_w = A.shared_attention_ref(*x)
    torch.testing.assert_close(w, r_w, rtol=0, atol=1e-5)
    torch.testing.assert_close(out, r_out, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_kernel_unsorted_and_out_of_range_idx_on_card():
    """Rows of one block that read different streams (runs), and stream
    indices outside [0, G) that clamp."""
    _cuda()
    x = [t.cuda() for t in _inputs("image", S=64, B=1, G=5, seed=8)]
    rng = np.random.RandomState(8)
    idx = rng.randint(-2, 8, 64).astype(np.int32)
    x[4] = torch.from_numpy(idx).cuda()
    plan = A.attention_plan(64, 1, 5, 64, 32)._replace(rows_per_block=8)
    out, w = A.run_shared_attention(x, plan)
    r_out, r_w = A.shared_attention_ref(*x)
    torch.testing.assert_close(w, r_w, rtol=0, atol=1e-5)
    torch.testing.assert_close(out, r_out, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["shared", "row", "project"])
def test_kernels_repeat_bitwise_on_card(op):
    """Two launches on the same inputs give the same bits: the split
    partials are summed in a fixed order, with no atomics."""
    _cuda()
    if op == "shared":
        x = [t.cuda() for t in _inputs("image", S=160, B=2, G=16, R=1000,
                                       H=512, D=1000, seed=9)]
        fn = A.shared_attention
    elif op == "row":
        x = [t.cuda() for t in _row_inputs(R=160, Hin=1000, H=512, D=1000,
                                           seed=9)]
        fn = A.row_attention
    else:
        x = [t.cuda() for t in _project_inputs(320, 1000, 512, seed=9)]
        fn = A.attention_project
    first, second = fn(*x), fn(*x)
    torch.cuda.synchronize()
    for a, b in zip(first if op != "project" else [first],
                    second if op != "project" else [second]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("op", ["shared", "row", "project"])
def test_launchers_refuse_gradients_before_launching(op):
    """The kernels are forward-only: asked for a gradient, the launchers
    raise before building or launching anything (here on CPU tensors, so
    nothing could launch), and never detach silently."""
    if op == "shared":
        x = _inputs("image")
        call = lambda: A.run_shared_attention(x, A.attention_plan(
            37, 2, 5, 64, 32))
    elif op == "row":
        x = _row_inputs()
        call = lambda: A.run_row_attention(x, A.attention_plan(
            9, 1, 9, 64, 32))
    else:
        x = _project_inputs(9, 64, 32)
        call = lambda: A.run_attention_project(*x, A.project_plan(9, 64, 32))
    x[0].requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        call()


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["shared", "row", "project"])
def test_wrappers_refuse_gradients_on_card(op):
    """On the card each wrapper raises when autograd would need a gradient
    through the kernel (grad mode on, an input requiring grad), and runs
    under torch.no_grad() with outputs that carry no grad_fn."""
    _cuda()
    if op == "shared":
        x, fn = [t.cuda() for t in _inputs("image")], A.shared_attention
    elif op == "row":
        x, fn = [t.cuda() for t in _row_inputs()], A.row_attention
    else:
        x = [t.cuda() for t in _project_inputs(9, 64, 32)]
        fn = A.attention_project
    x[-1].requires_grad_()                  # a weight, as in training
    with pytest.raises(RuntimeError, match="forward-only"):
        fn(*x)
    with torch.no_grad():
        out = fn(*x)
    torch.cuda.synchronize()
    for t in (out if isinstance(out, tuple) else (out,)):
        assert t.grad_fn is None


# ---- the bfloat16 storage variants (the compute_dtype="bfloat16" chain):
# h, p_att, att, wh and v bf16; bh, bv and mask float32.  Kernel against
# plain at the CPU tests' tolerances (tests/test_torch_port_bf16_attention
# .py): shared weights atol 2e-3 and att_res, rounded to bf16 as its
# consumer rounds it, rtol 1e-2 (a float32 sum in another order may round
# ``ah`` one bf16 ulp apart); row and projection float32 math, as in
# float32.

BF16 = torch.bfloat16


def _to_bf16(x, at):
    """The tensors of ``x`` at positions ``at`` (the streams) in bf16."""
    return [t.to(BF16) if i in at else t for i, t in enumerate(x)]


SHARED_STREAMS = (0, 1, 2, 5, 7)       # h, p_att, att, wh, v
ROW_STREAMS = (0, 1, 2, 4, 6)


def _close_bf16_shared(out, w, r_out, r_w):
    torch.testing.assert_close(w, r_w, rtol=0, atol=2e-3)
    torch.testing.assert_close(out.to(BF16).float(), r_out.to(BF16).float(),
                               rtol=1e-2, atol=1e-6)


def test_check_accepts_bf16_streams():
    x = _to_bf16(_inputs("image"), SHARED_STREAMS)
    assert A._check(*x) == (37, 2, 64, 5, 37, 32, 64)
    assert A._check_rows(*_to_bf16(_row_inputs(), ROW_STREAMS)) == \
        (9, 64, 37, 32, 64)


@pytest.mark.parametrize("bad", ["h", "p_att", "wh", "v", "bh", "bv",
                                 "mask"])
def test_check_rejects_mixed_storage_dtypes(bad):
    """One stream left float32, or a float32-only tensor in bf16: both
    the shared and the per-row checks raise (on any device)."""
    pos = {"h": 0, "p_att": 1, "wh": 5, "v": 7, "bh": 6, "bv": 8,
           "mask": 3}[bad]
    x = _to_bf16(_inputs("subgraph"), SHARED_STREAMS)
    x[pos] = x[pos].float() if x[pos].dtype == BF16 else x[pos].to(BF16)
    with pytest.raises(TypeError):
        A._check(*x)
    row = [x[i] for i in (0, 1, 2, 3, 5, 6, 7, 8)]
    row[0] = row[0][:, 0]
    with pytest.raises(TypeError):
        A._check_rows(*row)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["image", "subgraph"])
@pytest.mark.parametrize("beams", [1, 2, 3, 4])
def test_bf16_kernel_matches_plain_on_card(layout, beams):
    _cuda()
    x = [t.cuda() for t in _to_bf16(_inputs(layout, B=beams, seed=beams),
                                    SHARED_STREAMS)]
    A.reset_launch_counts()
    out, w = A.shared_attention(*x)
    torch.cuda.synchronize()
    assert (A.SHARED_BF16_LAUNCHES, A.LAUNCHES, A.PROJECT_LAUNCHES) == \
        (1, 0, 1)
    assert out.dtype == w.dtype == torch.float32
    _close_bf16_shared(out, w, *A.shared_attention_ref(*x))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["image", "subgraph"])
@pytest.mark.parametrize("knobs", [
    dict(splits=1), dict(splits=4), dict(bm=32, bn=128, splits=2),
    dict(bm=16, bn=128, splits=3), dict(rows_per_block=4)])
@pytest.mark.parametrize("dims", [dict(H=52, D=68), dict(H=64, D=66),
                                  dict(H=64, D=72)])
def test_bf16_kernel_plans_match_plain_on_card(layout, knobs, dims):
    """Plans of the tensor-core projection, at widths off the vector paths:
    a p_att row of 104 bytes (no bulk copy), att rows of 66 and 68 values
    (no 16-byte loads), and at H=64, D=72 on them; Hin = 130 (no 16-byte
    copies of h)."""
    _cuda()
    x = [t.cuda() for t in _to_bf16(_inputs(
        layout, S=41, B=2, G=5, R=130, seed=len(knobs), **dims),
        SHARED_STREAMS)]
    knobs = dict(knobs)
    rpb = knobs.pop("rows_per_block", 1)
    plan = A.project_plan_bf16(82, 130, dims["H"], **knobs)._replace(
        rows_per_block=rpb)
    _close_bf16_shared(*A.run_shared_attention(x, plan),
                       *A.shared_attention_ref(*x))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    dict(R=1), dict(R=9), dict(R=160, Hin=1000, H=512, D=1000),
    dict(R=100, Hin=1000, H=512, D=1000),
    dict(R=37, Hin=130, H=50, D=70), dict(R=300, Hin=96, H=200, D=128)])
def test_bf16_row_kernel_matches_plain_on_card(shape):
    """bf16 streams, float32 math in both (``_attention_kernel``'s
    promotion): the float32 tolerances.  R = 100 gives each block an SM of
    its own, so its blocks take twice the threads."""
    _cuda()
    x = [t.cuda() for t in _to_bf16(_row_inputs(seed=shape["R"], **shape),
                                    ROW_STREAMS)]
    A.reset_launch_counts()
    out, w = A.row_attention(*x)
    torch.cuda.synchronize()
    assert (A.ROW_BF16_LAUNCHES, A.ROW_LAUNCHES) == (1, 0)
    r_out, r_w = A.row_attention_ref(*x)
    torch.testing.assert_close(w, r_w, rtol=0, atol=1e-5)
    torch.testing.assert_close(out, r_out, rtol=1e-4, atol=1e-4)


# the tensor-core projection: every tile (16-128 rows, 64 or 128 columns),
# Q off a multiple of the tile, Hin and H off multiples of 8 (no 16-byte
# copies) and of 16, the full-width query counts of the decode (3, 160,
# 320, 2000), split on and off
@pytest.mark.cuda
@pytest.mark.parametrize("Q,Hin,H,knobs", [
    (1, 64, 32, {}), (37, 130, 50, {}), (37, 130, 50, dict(splits=3)),
    (200, 1000, 512, dict(splits=5)), (130, 1000, 200, dict(bm=128, bn=128)),
    (320, 1000, 512, {}), (3, 1000, 512, {}), (160, 1000, 512, {}),
    (2000, 1000, 512, {}), (70, 18, 130, dict(bm=16, bn=128, splits=1)),
    (45, 33, 520, dict(bm=32)), (300, 96, 200, dict(bm=64, bn=128)),
    (17, 1000, 512, dict(bm=16, splits=16))])
def test_bf16_project_kernel_matches_plain_on_card(Q, Hin, H, knobs):
    _cuda()
    x = [t.cuda() for t in _project_inputs(Q, Hin, H, seed=Q)]
    x[0], x[1] = x[0].to(BF16), x[1].to(BF16)
    ah = A.run_attention_project(*x, A.project_plan_bf16(Q, Hin, H,
                                                         **knobs))
    torch.cuda.synchronize()
    assert ah.dtype == torch.float32
    torch.testing.assert_close(ah, A.attention_project_ref(*x), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["shared", "row", "project", "shared_fullgc",
                                "shared_fanout", "project_q3"])
def test_bf16_kernels_repeat_bitwise_on_card(op):
    """Two launches give the same bits: the tensor-core projection's splits
    are summed in split order, with no atomics, at 16 splits (Q = 3) too."""
    _cuda()
    if op == "shared":
        x = _to_bf16(_inputs("image", S=160, B=2, G=16, R=1000, H=512,
                             D=1000, seed=9), SHARED_STREAMS)
        fn = A.shared_attention
    elif op == "shared_fullgc":
        x = _to_bf16(_inputs("subgraph", S=1, B=3, R=1000, H=512, D=1000,
                             seed=10), SHARED_STREAMS)
        fn = A.shared_attention
    elif op == "shared_fanout":
        x = _to_bf16(_inputs("image", S=2000, B=1, G=2, R=1000, H=512,
                             D=1000, seed=11), SHARED_STREAMS)
        fn = A.shared_attention
    elif op == "row":
        x = _to_bf16(_row_inputs(R=160, Hin=1000, H=512, D=1000, seed=9),
                     ROW_STREAMS)
        fn = A.row_attention
    else:
        Q = 3 if op == "project_q3" else 320
        x = _to_bf16(_project_inputs(Q, 1000, 512, seed=9), (0, 1))
        fn = A.attention_project
    x = [t.cuda() for t in x]
    first, second = fn(*x), fn(*x)
    torch.cuda.synchronize()
    for a, b in zip(first if op != "project" else [first],
                    second if op != "project" else [second]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("layout,S,G,B", [
    ("image", 160, 16, 2), ("subgraph", 160, 160, 2), ("image", 2000, 2, 1),
    ("subgraph", 1, 1, 3), ("image", 80, 8, 2)])
def test_bf16_kernel_matches_plain_at_full_width_on_card(layout, S, G, B):
    """The decode's bf16 shapes at full width (Hin = D = 1000, H = 512):
    Sub_GC_Kar in both beam layouts, the M-RNN fan-out, Full_GC_Kar's three
    beams, a serving dispatch; the 16-byte paths of both kernels, and (the
    last two: no more blocks than SMs) the attention blocks of twice the
    threads."""
    _cuda()
    x = [t.cuda() for t in _to_bf16(_inputs(
        layout, S=S, B=B, G=G, R=1000, H=512, D=1000, seed=S + B),
        SHARED_STREAMS)]
    _close_bf16_shared(*A.shared_attention(*x), *A.shared_attention_ref(*x))


def _unaligned(t):
    """A contiguous copy of ``t`` whose data starts 2 bytes past a 16-byte
    boundary: the kernels' 16-byte paths must stand aside."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = flat[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["shared", "row", "project"])
def test_bf16_kernels_take_unaligned_rows_on_card(op):
    """h, wh and the streams off 16-byte alignment (the value-by-value
    copies of the projection's ring, the unvectorised attention kernel) at
    full width."""
    _cuda()
    if op == "shared":
        x = [t.cuda() for t in _to_bf16(_inputs(
            "image", S=40, B=2, G=4, R=1000, H=512, D=1000, seed=12),
            SHARED_STREAMS)]
        x = [_unaligned(t) if i in SHARED_STREAMS else t
             for i, t in enumerate(x)]
        _close_bf16_shared(*A.shared_attention(*x),
                           *A.shared_attention_ref(*x))
    elif op == "row":
        x = [t.cuda() for t in _to_bf16(_row_inputs(
            R=40, Hin=1000, H=512, D=1000, seed=12), ROW_STREAMS)]
        x = [_unaligned(t) if i in ROW_STREAMS else t
             for i, t in enumerate(x)]
        out, w = A.row_attention(*x)
        r_out, r_w = A.row_attention_ref(*x)
        torch.testing.assert_close(w, r_w, rtol=0, atol=1e-5)
        torch.testing.assert_close(out, r_out, rtol=1e-4, atol=1e-4)
    else:
        x = [t.cuda() for t in _project_inputs(70, 1000, 512, seed=12)]
        x[0], x[1] = _unaligned(x[0].to(BF16)), _unaligned(x[1].to(BF16))
        torch.testing.assert_close(A.attention_project(*x),
                                   A.attention_project_ref(*x), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["shared", "row"])
def test_bf16_wrappers_refuse_mixed_dtypes_and_gradients_on_card(op):
    _cuda()
    if op == "shared":
        x = [t.cuda() for t in _to_bf16(_inputs("image"), SHARED_STREAMS)]
        fn, h, bias = A.shared_attention, 0, 6
    else:
        x = [t.cuda() for t in _to_bf16(_row_inputs(), ROW_STREAMS)]
        fn, h, bias = A.row_attention, 0, 5
    for pos, dt in ((h, torch.float32), (bias, BF16)):
        bad = list(x)
        bad[pos] = bad[pos].to(dt)
        with pytest.raises(TypeError):
            fn(*bad)
    x[-1].requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        fn(*x)


# ---- thread safety: a server launches from several threads at once

def _hammer(fn, n_threads=16, per_thread=200):
    """``fn`` from ``n_threads`` threads at once, with a short switch
    interval so that an unlocked read-modify-write would lose updates."""
    import sys
    import threading
    barrier = threading.Barrier(n_threads)
    errors = []

    def work():
        try:
            barrier.wait(timeout=30)
            for _ in range(per_thread):
                fn()
        except Exception as e:         # pragma: no cover - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts) and not errors, errors


def test_launch_counts_from_many_threads_are_exact():
    """Every count of 16 x 200 concurrent launches is kept."""
    A.reset_launch_counts()
    names = ["LAUNCHES", "ROW_LAUNCHES", "SHARED_BF16_LAUNCHES",
             "ROW_BF16_LAUNCHES"]
    i = iter(range(10 ** 9))
    _hammer(lambda: A.count_launch(names[next(i) % 4]))
    assert [getattr(A, n) for n in names] == [800] * 4
    assert A.PROJECT_LAUNCHES == 3200
    A.reset_launch_counts()
    assert A.PROJECT_LAUNCHES == A.LAUNCHES == 0


def test_first_kernel_lookup_loads_once_across_threads(monkeypatch):
    """Threads racing to the first call of an entry load the library and
    set the entry's signature once (the build itself is _build.load's,
    under its own lock)."""
    import time
    from subgc_tpu_torch.ops import _build
    loads = []

    class Lib:
        def __getattr__(self, name):
            return type("Entry", (), {})()

    def slow_load(name):
        loads.append(name)
        time.sleep(0.05)              # a build takes a while
        return Lib()

    monkeypatch.setattr(_build, "load", slow_load)
    monkeypatch.setattr(A, "_FNS", {})
    got = []
    _hammer(lambda: got.append(A._fn("subgc_row_attention_f32", 11, 8)),
            n_threads=8, per_thread=5)
    assert loads == ["attention"]
    assert len({id(f) for f in got}) == 1 and len(got) == 40


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["shared", "row", "shared_bf16", "row_bf16"])
def test_launch_counts_exact_under_concurrent_launches_on_card(op):
    """8 threads launch a wrapper 25 times each on the card (the serving
    pattern): every launch is counted, once, and every result equals the
    single-threaded one."""
    _cuda()
    if op.startswith("shared"):
        x = _inputs("subgraph", S=80, B=2, seed=3)
        fn, counter = A.shared_attention, "LAUNCHES"
        if op.endswith("bf16"):
            x, counter = _to_bf16(x, SHARED_STREAMS), "SHARED_BF16_LAUNCHES"
    else:
        x = _row_inputs(R=320, seed=3)
        fn, counter = A.row_attention, "ROW_LAUNCHES"
        if op.endswith("bf16"):
            x, counter = _to_bf16(x, ROW_STREAMS), "ROW_BF16_LAUNCHES"
    x = [t.cuda() for t in x]
    want = fn(*x)
    torch.cuda.synchronize()
    A.reset_launch_counts()
    outs = []
    _hammer(lambda: outs.append(fn(*x)), n_threads=8, per_thread=25)
    torch.cuda.synchronize()
    assert getattr(A, counter) == 200 and A.PROJECT_LAUNCHES == 200
    others = {"LAUNCHES", "ROW_LAUNCHES", "SHARED_BF16_LAUNCHES",
              "ROW_BF16_LAUNCHES"} - {counter}
    assert all(getattr(A, n) == 0 for n in others)
    for out in outs:
        for a, b in zip(out, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_first_build_and_load_from_many_threads_on_card(tmp_path,
                                                        monkeypatch):
    """Threads that all make the first call into a fresh build directory:
    nvcc runs once, and every thread gets the kernel's answer."""
    _cuda()
    from subgc_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_INFO", {})
    monkeypatch.setattr(A, "_FNS", {})
    runs = []
    real_run = _build.subprocess.run

    def counted(*a, **k):
        runs.append(a)
        return real_run(*a, **k)

    monkeypatch.setattr(_build.subprocess, "run", counted)
    x = [t.cuda() for t in _row_inputs(R=16, seed=4)]
    want = A.row_attention_ref(*x)
    outs = []
    _hammer(lambda: outs.append(A.row_attention(*x)), n_threads=6,
            per_thread=1)
    torch.cuda.synchronize()
    assert len(runs) == 1 and len(outs) == 6
    assert len([f for f in tmp_path.iterdir() if f.suffix == ".so"]) == 1
    for out, w in outs:
        torch.testing.assert_close(w, want[1], rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_kernels_launch_on_their_tensors_card_from_another_current_device():
    """The launchers make the tensors' card current: inputs on ``cuda:1``,
    launched from a thread whose current device is ``cuda:0``, give the
    plain versions' results on ``cuda:1`` (the shared and row kernels and
    the projection alone)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", 1)
    shared = [t.to(dev) for t in _inputs("image", seed=3)]
    row = [t.to(dev) for t in _row_inputs(seed=4)]
    out = {}

    def work():
        torch.cuda.set_device(0)
        with torch.no_grad():
            out["shared"] = A.shared_attention(*shared)
            out["row"] = A.row_attention(*row)
            out["project"] = A.attention_project(row[0], row[4], row[5])
        torch.cuda.synchronize(dev)

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive() and sorted(out) == ["project", "row", "shared"]
    for name, ref in (("shared", A.shared_attention_ref(*shared)),
                      ("row", A.row_attention_ref(*row))):
        (o, w), (r_o, r_w) = out[name], ref
        assert o.device == dev
        torch.testing.assert_close(w, r_w, rtol=0, atol=1e-5)
        torch.testing.assert_close(o, r_o, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(
        out["project"], A.attention_project_ref(row[0], row[4], row[5]),
        rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_one_rank_nccl_train_step_on_card(tmp_path):
    """A one-rank NCCL group on ``cuda:0`` runs the data-parallel step
    (its gradient bucket and BatchNorm moments all-reduced by NCCL) and
    matches the single-process step: losses rtol 1e-5, the gradients the
    optimizer gets rtol 2e-4 (``same_gradients``), parameters rtol 2e-4 /
    atol 1e-6, the val pass through the row kernel."""
    _cuda()
    from dataclasses import asdict

    from subgc_tpu_torch.config import ModelConfig, TrainConfig
    from subgc_tpu_torch.data.synthetic import synthetic_train_batch
    from subgc_tpu_torch.parallel import steps as PS
    cfg = ModelConfig(vocab_size=50, rnn_size=64, input_encoding_size=48,
                      att_hid_size=32, gcn_dim=40, fc_feat_size=64,
                      att_feat_size=80, embed_dim=20, num_obj_classes=30,
                      num_rel_classes=10, gcn_bn=True, use_gpn=False,
                      noun_fuse=False, pred_emb_type=2)
    spec = dict(cfg=asdict(cfg), tcfg=asdict(TrainConfig(batch_size=4)),
                params_seed=3, seed=7, steps=[None, 0.25],
                batches=[synthetic_train_batch(cfg, 4, s) for s in (1, 2)],
                val_batch=synthetic_train_batch(cfg, 4, 9), grads=True)
    (report,), = PS.run_ranks([spec], ["cuda:0"], str(tmp_path))
    ref = PS.run_steps(spec, "cuda:0")
    assert report["backend"] == "nccl"
    np.testing.assert_allclose([m["loss"] for m in report["metrics"]],
                               [m["loss"] for m in ref["metrics"]],
                               rtol=1e-5)
    assert PS.same_gradients(report, ref) == []
    assert PS.same_parameters(report, ref) == []
    np.testing.assert_allclose(report["val_loss"], ref["val_loss"],
                               rtol=1e-5)
    assert report["val_launches"]["row"] == cfg.seq_length + 1

