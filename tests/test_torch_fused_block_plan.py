"""Kernel 5's launch plan (ops/fused_block.py::block_plan) on the CPU: the
cut of the carry into blocks that fused_block.cu receives, its shared bytes
and its copy width, at ResNet-152's four identity-block shapes and at the
card tests' shapes; and the kernels' build when their sources are missing."""

from pathlib import Path

import pytest

from adaptive_tpu_torch.ops import fused_block as fb
from adaptive_tpu_torch.ops.cuda import build
from tests.torch_port_util import port_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent

# ResNet-152's identity-block layers at batch 1,024: (H = W, C, M) and the
# plan's rows and images a block, column chunk (block_plan's docstring)
LAYERS = [((56, 256, 64), (6, 1, 64)), ((28, 512, 128), (4, 1, 128)),
          ((14, 1024, 256), (5, 1, 128)), ((7, 2048, 512), (7, 1, 128))]
CARD_SHAPES = [(1, 4, 4, 16, 16), (3, 7, 7, 24, 24), (3, 8, 8, 64, 16), (1, 7, 7, 16, 64),
               (3, 4, 8, 24, 64), (2, 13, 5, 64, 24), (3, 7, 7, 64, 64), (5, 7, 7, 64, 64),
               (1, 14, 14, 256, 64), (1, 1, 1, 16, 16), (2, 5, 6, 24, 40), (2, 14, 14, 1024, 256),
               (3, 13, 13, 256, 64)]


def _check_cover(plan, B, H, W):
    """Every output row in exactly one block; each block's stage-1 rows are
    its output rows and every 3x3 neighbour of them inside their image."""
    p1max, p2max = fb._plan_rows(H, W, plan.rows, plan.images)
    seen = []
    ranges = list(fb.block_ranges(plan, B, H, W))
    assert len(ranges) == plan.blocks
    for o0, p2, i0, p1 in ranges:
        assert 0 < p2 <= p2max and 0 < p1 <= p1max and i0 <= o0 and o0 + p2 <= i0 + p1
        seen.extend(range(o0, o0 + p2))
        for r in (o0, o0 + p2 - 1):  # the first and last output rows' neighbours
            img, pix = divmod(r, H * W)
            y = pix // W
            for yy in (y - 1, y + 1):
                if 0 <= yy < H:
                    assert i0 <= (img * H + yy) * W + pix % W < i0 + p1
        assert o0 // (H * W) == i0 // (H * W) == (i0 + p1 - 1) // (H * W) or plan.images > 1
    assert seen == list(range(B * H * W))


@pytest.mark.parametrize("shape,cut", LAYERS)
def test_block_plan_at_resnet152_layers(shape, cut):
    H, C, M = shape
    plan = fb.block_plan(1024, H, H, C, M)
    assert (plan.rows, plan.images, plan.nt) == cut
    assert plan.smem == fb.block_smem(H, H, M, plan.rows, plan.images, plan.nt,
                                      plan.kt) <= fb.MAX_SMEM == 232448
    assert plan.sms == 2 and plan.smem <= fb.TWO_BLOCK_SMEM == 115712  # two blocks an SM
    assert plan.vec == 16 and plan.kt + 16 >= plan.nt
    _check_cover(plan, 1024, H, H)


@pytest.mark.parametrize("shape", [s for s, _ in LAYERS])
def test_block_plan_is_the_cheapest_plan_that_fits(shape):
    """No other cut or chunk that fits its shared bytes costs less under
    plan_cost, whether it fits two blocks an SM or one."""
    H, C, M = shape
    plan = fb.block_plan(1024, H, H, C, M)
    best = fb.plan_cost(plan, H, H, C, M)
    for R, G in list(fb._candidates(1024, H))[: 2 * H + 4]:
        for nt, kt in ((64, 64), (64, 128), (128, 128)):
            p = fb.make_plan(1024, H, H, C, M, R, G, nt, kt)
            if p.smem <= fb.MAX_SMEM:
                assert fb.plan_cost(p, H, H, C, M) >= best


def test_stage_cost_skips_the_tiles_past_a_pass():
    """A pass of 70 rows over 2 warps down (column chunks of 128): 5 tiles,
    the slowest warp takes 3, so 96 rows are paid for, not 128."""
    assert fb._stage_cost(70, 128, 128, 128, 1, 128) == 96 * 128 * 128 + 1 * fb.STEP_MACS
    assert fb._stage_cost(256, 128, 128, 128, 1, 128) == 2 * (128 * 128 * 128 + fb.STEP_MACS)


def test_block_smem_layout():
    """Layer3's plan, by hand: z1 of 98 rows (a 5-row band and its halo of
    14-pixel rows) and z2 of 70 rows, 256 + 16 bytes each, a zero row, and
    2 ring slots of 128 weight rows and 98 x rows of 144 bytes."""
    plan = fb.block_plan(1024, 14, 14, 1024, 256)
    assert (plan.nt, plan.kt, plan.blocks, fb.RING_STAGES) == (128, 128, 3072, 2)
    assert plan.smem == (98 + 70 + 1) * 272 + 2 * (128 + 98) * 144
    # a band: z1 holds the band and its two halo rows, the ring at most a pass of x rows
    assert fb.block_smem(56, 56, 64, 4, 1, 64, 128) == (6 * 56 + 4 * 56 + 1) * 80 + 2 * (64 + 256) * 144


@pytest.mark.parametrize("B,H,W,C,M", CARD_SHAPES)
def test_block_plan_at_card_test_shapes(B, H, W, C, M):
    plan = fb.block_plan(B, H, W, C, M)
    assert plan.smem <= fb.MAX_SMEM
    assert plan.images == 1 or plan.rows == H
    _check_cover(plan, B, H, W)


@pytest.mark.parametrize("B,H,W,rows,images", [(5, 7, 7, 7, 2), (5, 7, 7, 7, 3), (5, 7, 7, 3, 1),
                                                (1, 14, 14, 2, 1), (1, 12, 40, 6, 1), (2, 5, 6, 2, 1)])
def test_forced_plans_cover_every_row_once(B, H, W, rows, images):
    """The cuts of the card test that forces plans: ragged last groups and
    bands still cover every row once."""
    _check_cover(fb.make_plan(B, H, W, 64, 64, rows, images, 64, 128), B, H, W)


def test_copy_width_rule():
    """16-byte copies need every weight and x row to start 16-byte aligned:
    C and M multiples of 16; else 8-byte copies (C and M are multiples of
    8). x itself is refused unless 16-byte aligned (_check_cuda)."""
    assert fb.block_plan(2, 5, 6, 24, 40).vec == 8
    assert fb.block_plan(2, 5, 6, 32, 40).vec == 8
    assert fb.block_plan(2, 5, 6, 24, 32).vec == 8
    assert fb.block_plan(2, 5, 6, 32, 48).vec == 16


def test_block_plan_refuses_rows_that_do_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        fb.block_plan(1, 4, 400, 512, 512)


def test_build_names_missing_sources(tmp_path, monkeypatch):
    """An install without csrc/*.cu says what is missing before it looks
    for nvcc (there is none here)."""
    (tmp_path / "csrc").mkdir()
    monkeypatch.setattr(build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no CUDA kernel sources"):
        build.build()
    with pytest.raises(RuntimeError, match=str(tmp_path / "csrc")):
        build.build()


def test_package_data_ships_the_kernel_sources():
    tomllib = pytest.importorskip("tomllib")  # Python 3.11 and later
    with open(REPO / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    patterns = data["adaptive_tpu_torch.ops.cuda"]
    shipped = {p.name for pat in patterns for p in build.HERE.glob(pat)}  # package-relative
    assert shipped == {p.name for p in build.CSRC.iterdir() if p.suffix in (".cu", ".cuh")}
    assert {p.name for p in build.CSRC.glob("*.cu")} <= shipped
