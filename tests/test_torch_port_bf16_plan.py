"""The launch plan of the bf16 tensor-core projection
(``ops/attention.py::project_plan_bf16``), on the CPU.

The bf16 entries of ``csrc/attention.cu`` multiply with ``mma.m16n8k16``:
tiles of 16 to 128 queries, k in ring slices of 32 (two mma k-steps), k split
into a ``[splits, Q, H]`` scratch that the attention kernel sums in split
order.  The kernel refuses a plan with an empty split, so every plan the
wrappers can make is checked here for that, across the query counts the
decoder gives it (Q = 3 for Full_GC_Kar's three beams up to 2000 for the
M-RNN fan-out) and the narrow, ragged widths of the tests.

This file imports no jax, so it also runs on a GPU machine that has only
PyTorch:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_port_bf16_plan.py
"""
import pytest

from subgc_tpu_torch.ops import attention as A

# Full_GC_Kar (3 beams), serving (S=80 x 2), Kar and GRD (160, 320), the
# val pass, the fan-out (2000), a 96-image Kar batch
QUERIES = [1, 3, 16, 17, 160, 256, 257, 320, 1024, 1025, 2000, 1920]
# full width (Hin 1000, H 512) and the tests' narrow, ragged widths (Hin and
# H off multiples of 8 and 16)
WIDTHS = [(1000, 512), (130, 50), (18, 130), (96, 200), (64, 32), (7, 1),
          (1, 64), (33, 520)]


def _blocks(plan, Q, H):
    return -(-Q // plan.bm) * -(-H // plan.bn) * plan.splits


@pytest.mark.parametrize("Hin,H", WIDTHS)
def test_plan_slices_are_mma_steps_and_no_split_is_empty(Hin, H):
    assert A.K_SLICE_BF16 % 16 == 0          # whole mma k-steps
    for Q in QUERIES:
        plan = A.project_plan_bf16(Q, Hin, H)
        assert plan.bm in A.TILE_ROWS_BF16 and plan.bm % 16 == 0
        assert plan.bn in A.TILE_COLS
        assert plan.kchunk % A.K_SLICE_BF16 == 0 and plan.kchunk % 16 == 0
        assert 1 <= plan.splits <= A.MAX_SPLITS_BF16
        # every split holds k, and the splits cover Hin
        assert (plan.splits - 1) * plan.kchunk < Hin <= \
            plan.splits * plan.kchunk
        assert plan.rows_per_block == 1


def test_plan_is_the_wrappers_plan():
    """attention_plan(bf16=True) is project_plan_bf16 at S B queries with
    the attention's rows per block; without it the float32 plan stands."""
    for S, B, G in [(160, 2, 16), (1, 3, 1), (2000, 1, 2), (320, 1, 320)]:
        plan = A.attention_plan(S, B, G, 1000, 512, bf16=True)
        assert plan._replace(rows_per_block=1) == \
            A.project_plan_bf16(S * B, 1000, 512)
        assert plan.rows_per_block == A.rows_per_block(S, B, G)
        assert A.attention_plan(S, B, G, 1000, 512) == \
            A.project_plan(S * B, 1000, 512)._replace(
                rows_per_block=A.rows_per_block(S, B, G))


@pytest.mark.parametrize("Q", [3, 2000])
def test_plan_fills_the_card_at_three_queries_and_at_two_thousand(Q):
    """Q = 3 (one 16-row tile) splits k until there are about as many
    blocks as SMs; Q = 2000 takes 128-row tiles and still ~2 blocks per SM,
    without splitting k more than that."""
    plan = A.project_plan_bf16(Q, 1000, 512)
    blocks = _blocks(plan, Q, 512)
    assert 0.95 * A.SMS <= blocks <= 2 * A.SMS
    assert plan.bm == (16 if Q == 3 else 128)
    assert plan.splits == (16 if Q == 3 else 2)


def test_plan_sweep_keeps_every_rule():
    """Every query count up to 2000 at full width: a valid plan with at
    least one block per SM's worth of work where tiles allow it."""
    for Q in range(1, 2001):
        plan = A.project_plan_bf16(Q, 1000, 512)
        assert (plan.splits - 1) * plan.kchunk < 1000 <= \
            plan.splits * plan.kchunk
        assert _blocks(plan, Q, 512) >= 0.95 * A.SMS


def test_overrides_are_trimmed_to_whole_splits():
    plan = A.project_plan_bf16(320, 130, 50, bm=128, bn=128, splits=9)
    assert (plan.bm, plan.bn) == (128, 128)
    assert plan.splits == 5 and plan.kchunk == 32      # 130 k: 5 slices
    assert A.project_plan_bf16(5, 1000, 512, splits=3) == \
        A.Plan(16, 64, 3, 352)


@pytest.mark.parametrize("kw", [dict(bm=48), dict(bm=8), dict(bn=32),
                                dict(bn=256), dict(splits=0),
                                dict(splits=-2), dict(Q=0), dict(Hin=0),
                                dict(H=0)])
def test_plan_raises_on_what_the_kernel_does_not_take(kw):
    args = dict(Q=320, Hin=1000, H=512)
    args.update({k: v for k, v in kw.items() if k in args})
    knobs = {k: v for k, v in kw.items() if k not in args}
    with pytest.raises(ValueError):
        A.project_plan_bf16(args["Q"], args["Hin"], args["H"], **knobs)
