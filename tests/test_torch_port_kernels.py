"""The port's CUDA kernel against its plain version, and the wrapper's checks.

This file imports neither jax nor the JAX package, so the ``cuda`` tests run
on a GPU machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_port_kernels.py

Without a card those tests skip; the wrapper's input checks run anywhere.
Kernel against plain: weights within atol 1e-5, att_res within rtol 1e-4 /
atol 1e-4 (float32 summation order).
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
