"""Kernel 6's launch plan (ops/fused_tail.py::tail_plan) on the CPU: the cut
of the carry rows into blocks that fused_tail.cu receives, its shared bytes
and its copy width, at ResNet-152's boundary shapes at batch 1,024 (within
a layer, M2 = M, and into the next layer's block 0, M2 = 2M) and at the
card tests' shapes."""

import pytest

from adaptive_tpu_torch.ops import fused_block as fb
from adaptive_tpu_torch.ops import fused_tail as ft
from tests.torch_port_util import port_threads  # noqa: F401

# ResNet-152's boundaries at batch 1,024: (N, C, M, M2) and the plan's rows a
# block, column chunk, K chunk and blocks an SM (tail_plan's choice)
BOUNDARIES = [
    ((1024 * 56 * 56, 256, 64, 64), (192, 64, 64, 2)),
    ((1024 * 56 * 56, 256, 64, 128), (96, 128, 128, 2)),
    ((1024 * 28 * 28, 512, 128, 128), (64, 128, 128, 2)),
    ((1024 * 28 * 28, 512, 128, 256), (64, 128, 128, 2)),
    ((1024 * 14 * 14, 1024, 256, 256), (48, 128, 128, 2)),
    ((1024 * 14 * 14, 1024, 256, 512), (48, 128, 128, 2)),
    ((1024 * 7 * 7, 2048, 512, 512), (64, 128, 128, 1)),
]
CARD_SHAPES = [(3 * 49, 24, 16, 24), (16, 16, 64, 16), (3 * 64, 64, 24, 64), (3 * 49 + 1, 16, 16, 16),
               (200, 64, 16, 24), (5, 32, 16, 48), (300, 1024, 256, 512), (200, 2048, 512, 512),
               (3 * 13 * 13, 256, 64, 128)]


def _check_cover(plan, N):
    """Every carry row in exactly one block, each block at most plan.rows
    rows and only the last one short."""
    ranges = list(ft.tail_ranges(plan, N))
    assert len(ranges) == plan.blocks == -(-N // plan.rows)
    seen = []
    for b, (r0, rows) in enumerate(ranges):
        assert 0 < rows <= plan.rows and (rows == plan.rows or b == plan.blocks - 1)
        seen.extend(range(r0, r0 + rows))
    assert seen == list(range(N))


@pytest.mark.parametrize("shape,cut", BOUNDARIES)
def test_tail_plan_at_resnet152_boundaries(shape, cut):
    """Two blocks an SM in layers 1-3, M2 = 2M included (each block's shared
    bytes within TWO_BLOCK_SMEM); layer4's 2,592 bytes a row fit 64 rows
    only one block an SM, which the cost model prefers to 32 rows two."""
    N, C, M, M2 = shape
    plan = ft.tail_plan(N, C, M, M2)
    assert (plan.rows, plan.nt, plan.kt, plan.sms) == cut
    assert plan.smem == ft.tail_smem(C, M, plan.rows, plan.nt, plan.kt) <= fb.MAX_SMEM
    assert (plan.smem <= fb.TWO_BLOCK_SMEM) == (plan.sms == 2)
    assert plan.vec == 16 and plan.kt + 16 >= plan.nt and plan.rows % 16 == 0
    _check_cover(plan, N)


@pytest.mark.parametrize("shape", [s for s, _ in BOUNDARIES])
def test_tail_plan_is_the_cheapest_plan_that_fits(shape):
    """No other row count or chunk that fits its shared bytes costs less
    under tail_cost, whether it fits two blocks an SM or one."""
    N, C, M, M2 = shape
    plan = ft.tail_plan(N, C, M, M2)
    best = ft.tail_cost(plan, C, M, M2)
    for rows in range(16, 513, 16):
        for nt, kt in ((64, 64), (64, 128), (128, 128)):
            p = ft.make_tail_plan(N, C, M, M2, rows, nt, kt)
            if p.smem <= fb.MAX_SMEM:
                assert ft.tail_cost(p, C, M, M2) >= best


def test_tail_smem_layout():
    """Layer3's plan, by hand: z2 of 48 rows of 256 + 16 bytes, the carry of
    48 rows of 1,024 + 16 bytes, and 2 ring slots of 128 weight rows and 48
    part rows of 144 bytes: two blocks fit an SM."""
    plan = ft.tail_plan(1024 * 14 * 14, 1024, 256, 256)
    assert (plan.rows, plan.nt, plan.kt, ft.RING_STAGES) == (48, 128, 128, 2)
    assert plan.smem == 48 * 272 + 48 * 1040 + 2 * (128 + 48) * 144 == 113664
    # rows past a pass: the ring's part holds one pass (256 rows at nt 64)
    assert ft.tail_smem(256, 64, 320, 64, 128) == 320 * (80 + 272) + 2 * (64 + 256) * 144
    # K tails: C = 24 and M = 40 rows are padded to 32 and 64 bytes, plus 16
    assert ft.tail_smem(24, 40, 16, 64, 64) == 16 * (80 + 48) + 2 * (64 + 16) * 80


@pytest.mark.parametrize("N,C,M,M2", CARD_SHAPES)
def test_tail_plan_at_card_test_shapes(N, C, M, M2):
    plan = ft.tail_plan(N, C, M, M2)
    assert plan.smem <= fb.MAX_SMEM and plan.rows % 16 == 0
    _check_cover(plan, N)


@pytest.mark.parametrize("N,rows", [(200, 48), (5, 16), (148, 32), (700, 320), (700, 160),
                                    (300, 48), (200, 64), (1024 * 7 * 7, 48)])
def test_forced_plans_cover_every_row_once(N, rows):
    """The card test's forced plans, and layer4's rows at 48 a block: the
    last block ragged where N is not a multiple of the rows."""
    _check_cover(ft.make_tail_plan(N, 64, 64, 64, rows, 64, 128), N)


def test_copy_width_rule():
    """16-byte copies need every row of x, z2, out, z1 and both weights to
    start 16-byte aligned: C, M and M2 multiples of 16; else 8-byte copies
    (all three are multiples of 8). The tensors themselves are refused
    unless 16-byte aligned (_check_cuda)."""
    assert ft.tail_plan(100, 24, 16, 16).vec == 8
    assert ft.tail_plan(100, 32, 40, 16).vec == 8
    assert ft.tail_plan(100, 32, 16, 24).vec == 8
    assert ft.tail_plan(100, 32, 48, 16).vec == 16


def test_tail_plan_refuses_rows_that_do_not_fit():
    """16 rows of a 16,384-channel carry and its z2 take 16 x (16,400 +
    4,112) bytes, past MAX_SMEM with any ring."""
    with pytest.raises(ValueError, match="shared memory"):
        ft.tail_plan(64, 16384, 4096, 64)

