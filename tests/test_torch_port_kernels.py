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
    assert torch.equal(out, r_out) and torch.equal(w, r_w)


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
