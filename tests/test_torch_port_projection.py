"""The attention kernels' projection stage on the CPU: its plain version
against the JAX chain's projection, and the tile plan that the wrappers hand
to the CUDA kernels.

This file imports no jax at module level (the JAX comparison imports it in
its test and skips without it), so it also runs on a GPU machine that has
only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_port_projection.py

Tolerance of the projection against JAX: rtol 1e-5 / atol 1e-5 (float32,
summation order differs).
"""
import numpy as np
import pytest
import torch

from subgc_tpu_torch.ops import attention as A

# the query counts chip_smoke.py and the decoder give the projection: Kar's
# 16- and 96-image beam batches (S B = 320, 1920), 32 images (640), the
# fan-out at 2 and 8 images (2000, ~7300), and the grounding rows
QUERIES = [320, 640, 1920, 2000, 7300, 160, 960]
WIDTHS = [512, 50, 200]


def _project_inputs(Q, Hin, H, seed=0):
    rng = np.random.RandomState(seed)
    bound = 1.0 / np.sqrt(Hin)
    return [rng.uniform(-1, 1, (Q, Hin)).astype("f"),
            rng.uniform(-bound, bound, (Hin, H)).astype("f"),
            rng.uniform(-bound, bound, (H,)).astype("f")]


@pytest.mark.parametrize("Q,Hin,H", [(7, 64, 32), (160, 130, 50),
                                     (320, 1000, 512)])
def test_project_ref_matches_jax_projection(Q, Hin, H):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from subgc_tpu.models.decoder import _dense
    h, wh, bh = _project_inputs(Q, Hin, H, seed=Q)
    # full float32 on the CPU, wherever jax would otherwise place it (a GPU
    # backend multiplies float32 in TF32 by default)
    with jax.default_device(jax.devices("cpu")[0]), \
            jax.default_matmul_precision("highest"):
        want = np.asarray(_dense(jnp.asarray(h), {"w": jnp.asarray(wh),
                                                  "b": jnp.asarray(bh)},
                                 jnp.float32))
    got = A.attention_project_ref(*map(torch.from_numpy, (h, wh, bh)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_project_wrapper_on_cpu_is_plain_and_uncounted():
    x = [torch.from_numpy(a) for a in _project_inputs(9, 40, 24, seed=3)]
    before = A.PROJECT_LAUNCHES
    got = A.attention_project(*x)
    assert A.PROJECT_LAUNCHES == before
    assert torch.equal(got, A.attention_project_ref(*x))


def _blocks(plan, Q, Hin, H):
    """The (queries, columns, k) ranges of each projection block, in the
    kernel's index arithmetic: grid (ceil(Q/bm), ceil(H/bn), splits), block
    (x, y, z) at queries x bm, columns y bn, k from z kchunk."""
    for z in range(plan.splits):
        k0 = z * plan.kchunk
        for x in range(-(-Q // plan.bm)):
            for y in range(-(-H // plan.bn)):
                yield (range(x * plan.bm, min((x + 1) * plan.bm, Q)),
                       range(y * plan.bn, min((y + 1) * plan.bn, H)),
                       range(k0, min(k0 + plan.kchunk, Hin)))


def _coverage(plan, Q, Hin, H):
    """Per split: how often each (query, column) is computed; and the k
    ranges of the splits."""
    counts = np.zeros((plan.splits, Q, H), np.int32)
    kranges = {}
    for qs, js, ks in _blocks(plan, Q, Hin, H):
        z = ks.start // plan.kchunk
        counts[z, qs.start:qs.stop, js.start:js.stop] += 1
        kranges[z] = ks
    return counts, kranges


@pytest.mark.parametrize("H", WIDTHS)
@pytest.mark.parametrize("Q", QUERIES)
def test_plan_covers_every_query_and_column_once(Q, H):
    Hin = 1000
    plan = A.project_plan(Q, Hin, H)
    assert plan.bm in A.TILE_ROWS and plan.bn in A.TILE_COLS
    assert plan.kchunk % A.K_SLICE == 0
    counts, kranges = _coverage(plan, Q, Hin, H)
    assert (counts == 1).all()
    ks = [kranges[z] for z in range(plan.splits)]
    assert all(len(k) > 0 for k in ks)                 # no empty split
    assert [k.start for k in ks] == [0] + [k.stop for k in ks[:-1]]
    assert ks[-1].stop == Hin


@pytest.mark.parametrize("Hin", [1, 15, 16, 64, 130, 1000])
def test_plan_never_has_an_empty_split(Hin):
    for splits in range(1, 80):
        plan = A.project_plan(96, Hin, 32, splits=splits)
        assert 1 <= plan.splits <= splits
        assert (plan.splits - 1) * plan.kchunk < Hin <= \
            plan.splits * plan.kchunk


@pytest.mark.parametrize("bm", A.TILE_ROWS)
@pytest.mark.parametrize("bn", A.TILE_COLS)
def test_plan_overrides_cover_every_query_and_column(bm, bn):
    Q, Hin, H = 300, 130, 200
    plan = A.project_plan(Q, Hin, H, bm=bm, bn=bn, splits=3)
    assert (plan.bm, plan.bn) == (bm, bn)
    counts, _ = _coverage(plan, Q, Hin, H)
    assert (counts == 1).all()


def test_plan_rejects_tiles_without_a_kernel():
    with pytest.raises(ValueError):
        A.project_plan(320, 1000, 512, bm=48)
    with pytest.raises(ValueError):
        A.project_plan(320, 1000, 512, bn=32)


@pytest.mark.parametrize("Q,splits", [(320, 6), (2000, 2), (7300, 1),
                                      (160, 6), (960, 4)])
def test_plan_at_full_width(Q, splits):
    """Enough blocks for ~2 per SM at the main path's query counts."""
    plan = A.project_plan(Q, 1000, 512)
    assert plan.splits == splits
    blocks = -(-Q // plan.bm) * -(-512 // plan.bn) * plan.splits
    assert blocks >= A.SMS


@pytest.mark.parametrize("S,B,G,rpb", [
    (160, 2, 16, 1),        # Kar, image-shared, 16 images
    (160, 2, 160, 1),       # Kar, per-sub-graph
    (960, 2, 96, 4),        # Kar, 96 images
    (2000, 1, 2, 8),        # M-RNN fan-out, 2 images
    (7300, 1, 8, 16),       # M-RNN fan-out, 8 images
    (160, 1, 160, 1),       # grounding rows
    (600, 3, 2, 4),         # three beams: 12 queries, at most 16
])
def test_rows_per_block(S, B, G, rpb):
    got = A.rows_per_block(S, B, G)
    assert got == rpb
    assert got * B <= A.MAX_QUERIES_PER_BLOCK and got <= max(1, S // G)


@pytest.mark.parametrize("Q,H", [(320, 512), (2000, 512), (160, 50),
                                 (7, 200)])
def test_scratch_has_the_entry_points_shape(Q, H):
    """The C entry points write split z's partials at part + z Q H, for
    z < splits: a contiguous [splits, Q, H] float32 scratch."""
    plan = A.attention_plan(Q, 1, Q, 1000, H)
    part = A.project_scratch(plan, Q, H, "cpu")
    assert part.shape == (plan.splits, Q, H)
    assert part.dtype == torch.float32 and part.is_contiguous()
    z_max = max(ks.start // plan.kchunk
                for _, _, ks in _blocks(plan, Q, 1000, H))
    assert z_max == plan.splits - 1


@pytest.mark.parametrize("op", ["project", "shared", "row"])
def test_wrappers_raise_on_a_device_without_a_kernel(op):
    meta = dict(device="meta")
    if op == "project":
        args = (torch.empty(4, 8, **meta), torch.empty(8, 6, **meta),
                torch.empty(6, **meta))
        fn = A.attention_project
    elif op == "shared":
        args = (torch.empty(3, 2, 8, **meta), torch.empty(3, 5, 6, **meta),
                torch.empty(3, 5, 7, **meta), torch.empty(3, 5, **meta),
                torch.empty(3, dtype=torch.int32, **meta),
                torch.empty(8, 6, **meta), torch.empty(6, **meta),
                torch.empty(6, 1, **meta), torch.empty(1, **meta))
        fn = A.shared_attention
    else:
        args = (torch.empty(3, 8, **meta), torch.empty(3, 5, 6, **meta),
                torch.empty(3, 5, 7, **meta), torch.empty(3, 5, **meta),
                torch.empty(8, 6, **meta), torch.empty(6, **meta),
                torch.empty(6, 1, **meta), torch.empty(1, **meta))
        fn = A.row_attention
    with pytest.raises(ValueError, match="no kernel"):
        fn(*args)
