"""Fused int8 identity bottleneck block, with its plain twin (counterpart of
adaptive_tpu/ops/pallas/fused_block.py).

One call computes a whole ResNet bottleneck identity block on the s8 carry:

    z1 = requant(relu(conv1x1(x) * sc1 + b1), s2)
    z2 = requant(relu(conv3x3(z1) * sc2 + b2), s3)
    out = requant(relu(conv1x1(z2) * sc3 + b3 + x * s_in), s_out)

with the 3x3 conv zero-padded at each image's edges. Rows are the carry
viewed as [B*H*W, C] (image-major, then row, then column); weights are s8,
output channel first: w1 [M, C], w2 [M, 9*M] (taps (ky, kx) row-major, then
the input channel), w3 [C, M]; sc*/b* are fp32 per output channel and
s2, s3, s_in, s_out the carry's static scales (Python floats).

``bottleneck_identity_int8`` launches the CUDA kernel
(ops/cuda/csrc/fused_block.cu) for CUDA tensors and counts it in
``bottleneck_identity_int8.launches``; for CPU tensors it runs
``bottleneck_identity_int8_plain``, the int8 products (torch._int_mm, exact)
and the epilogues op for op as separate IEEE operations, which is the
arithmetic the kernel reproduces bit for bit. The TPU kernel matched its XLA
reference only up to +/-1 quantum at requant ties (FMA contraction); the
CUDA kernel writes its epilogues without contraction.

The kernel is bound by its int8 operations in layers 3 and 4 of ResNet-152
(4.47e11 a launch at batch 1,024: 0.226 ms at an H100 SXM's 1,979 TOPS) and
by the carry's bytes in layers 1 and 2 (x read and out written: 0.49 and
0.245 ms at 3.35 TB/s). A block runs the three products one after the other
on a ring of shared-memory slots: each weight chunk is copied once a block
(cp.async) and read by all 8 warps (ldmatrix into mma.sync s8), so the
weights cross L2 once a block, and a block owns as many rows as
``block_plan`` finds worth it: a band of whole image rows, or whole images,
two blocks an SM where their shared bytes fit (the kernel's registers are
capped for two).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Iterator, NamedTuple, Tuple

import torch

from adaptive_tpu_torch.ops.fused_step import (
    _check_cuda, _check_device, _check_shape, _ptr, _raise_on,
)
from adaptive_tpu_torch.ops.int8 import f32, im2col, int_mm, requant


def bottleneck_identity_int8_plain(x, H: int, W: int, w1, w2, w3, sc1, b1, sc2, b2, sc3, b3,
                                   s2: float, s3: float, s_in: float, s_out: float):
    """Plain twin of the fused block: x [B*H*W, C] s8 -> [B*H*W, C] s8."""
    N, C = x.shape
    M = w1.shape[0]
    z = torch.relu(int_mm(x, w1.t()).float() * sc1 + b1)
    z1 = requant(z, s2).reshape(N // (H * W), H, W, M)
    z = torch.relu(int_mm(im2col(z1, 3, 3, 1, ((1, 1), (1, 1))), w2.t()).float() * sc2 + b2)
    z2 = requant(z, s3)
    tail = int_mm(z2, w3.t()).float() * sc3 + b3
    return requant(torch.relu(tail + x.float() * f32(s_in, x)), s_out)


MAX_SMEM = 232448  # bytes of shared memory a block may use on an H100
# an H100 SM's 233,472 shared bytes hold two blocks of up to this many (each
# block also holds 1 KB for the system)
TWO_BLOCK_SMEM = 233472 // 2 - 1024
RING_PASS = {64: 256, 128: 128}  # rows a pass of the ring product, by column chunk nt
RING_STAGES = 2  # ring slots (int8_common.cuh::RING_STAGES)
# block_plan's cost model, fitted to tools/torch_int8_probe.py --sweep on an
# H100 (PERF.md): the fixed cost of a ring step (barrier, copies, fragment
# latency) and of a block (launch, three ring fills, z1 and z2 epilogues'
# tails) in multiply-adds of the block, and the gain of two blocks an SM
STEP_MACS = 283e3
BLOCK_MACS = 1e7
TWO_BLOCK_GAIN = 1.6
WARP_ROWS = {64: 4, 128: 2}  # warps down a pass's rows, by column chunk nt (RingLayout::WR)


class BlockPlan(NamedTuple):
    rows: int  # image rows a block: a band (H when images > 1)
    images: int  # whole images a block (1 for a band)
    nt: int  # output columns of a ring chunk: 64 (passes of 256 rows) or 128 (128 rows)
    kt: int  # K bytes of a ring chunk: 64 or 128 (128 where nt is: a residual tile row fits a ring row)
    smem: int  # shared bytes of a block
    blocks: int
    vec: int  # bytes a cp.async: 16 where C and M are multiples of 16 (rows 16-byte aligned), else 8

    @property
    def sms(self) -> int:
        """Blocks an SM: 2 where the shared bytes fit TWO_BLOCK_SMEM, else 1."""
        return 2 if self.smem <= TWO_BLOCK_SMEM else 1


def _act_ld(M: int) -> int:
    """Bytes of a shared row of z1 or z2: M padded to 32, plus 16."""
    return -(-M // 32) * 32 + 16


def _plan_rows(H: int, W: int, rows: int, images: int) -> Tuple[int, int]:
    """(P1max, P2max): the most stage-1 rows (a band and its one-row halo)
    and output rows a block holds."""
    p2 = images * H * W if images > 1 else rows * W
    return (p2 if images > 1 else min(rows + 2, H) * W), p2


def block_smem(H: int, W: int, M: int, rows: int, images: int, nt: int, kt: int) -> int:
    """Shared bytes of a block, as fused_block.cu::block_smem lays them out:
    z1 [P1max, ld], z2 [P2max, ld], a zero row of ld bytes, and the ring of
    RING_STAGES slots, each an nt-row weight chunk and up to a pass of x
    rows, kt + 16 bytes a row."""
    p1, p2 = _plan_rows(H, W, rows, images)
    return (p1 + p2 + 1) * _act_ld(M) + RING_STAGES * (nt + min(p1, RING_PASS[nt])) * (kt + 16)


def _candidates(B: int, H: int) -> Iterator[Tuple[int, int]]:
    """(rows, images) a block, by growing rows: bands of even height, one
    image, then groups of whole images."""
    for nb in range(H, 0, -1):
        R = -(-H // nb)
        if -(-H // R) == nb:
            yield R, 1
    for G in range(2, B + 1):
        yield H, G


def _stage_cost(P: int, nt: int, kt: int, N: int, nseg: int, K: int,
                step_macs: float = STEP_MACS) -> float:
    """A stage of P rows in multiply-adds, as ring_product spends them: per
    pass the rows of its slowest warp (16 WR ceil(tiles / WR): a warp skips
    its tiles past the pass) times N and K, plus step_macs a ring step."""
    pas, wr = RING_PASS[nt], WARP_ROWS[nt]
    steps = -(-N // nt) * nseg * -(-K // kt)
    cost = 0.0
    for p0 in range(0, P, pas):
        tiles = -(-min(pas, P - p0) // 16)
        cost += 16 * wr * -(-tiles // wr) * N * nseg * K + steps * step_macs
    return cost


def plan_cost(plan: BlockPlan, H: int, W: int, C: int, M: int) -> float:
    """The model block_plan minimises: blocks x (BLOCK_MACS + the three
    stages' cost of the largest block), over TWO_BLOCK_GAIN where two blocks
    share an SM."""
    p1, p2 = _plan_rows(H, W, plan.rows, plan.images)
    per_block = (BLOCK_MACS + _stage_cost(p1, plan.nt, plan.kt, M, 1, C)
                 + _stage_cost(p2, plan.nt, plan.kt, M, 9, M)
                 + _stage_cost(p2, plan.nt, plan.kt, C, 1, M))
    return plan.blocks * per_block / (TWO_BLOCK_GAIN if plan.sms == 2 else 1.0)


@functools.lru_cache(maxsize=64)
def block_plan(B: int, H: int, W: int, C: int, M: int) -> BlockPlan:
    """How kernel 5 cuts B images of H x W into blocks: the plan of least
    plan_cost among the cuts (bands of whole image rows, one image, groups
    of images), column chunks (64, 128) and K chunks (64, 128; 64 only with
    a column chunk of 64) whose shared bytes fit, two blocks an SM where
    they fit TWO_BLOCK_SMEM; ties go to fewer blocks. A block holds its
    rows' z1 and z2 in shared memory beside the ring, so rows cost shared
    bytes; more rows a block mean less halo, fewer ring steps a row and
    fewer weight bytes from L2; a pass whose rows fill its warps' tiles
    wastes none; and two blocks an SM hide each other's latencies (the
    epilogues' IEEE divisions, the barriers). ResNet-152 at batch 1,024: layer1 (56x56, C
    256, M 64) bands of 6 rows; layer2 (28x28, 512, 128) bands of 4 rows;
    layer3 (14x14, 1,024, 256) bands of 5 rows; layer4 (7x7, 2,048, 512)
    one image; all two blocks an SM, column chunks of 128 but in layer1.
    Raises ValueError where not one image row fits."""
    best, best_key = None, None
    for R, G in _candidates(B, H):
        if block_smem(H, W, M, R, G, 64, 64) > MAX_SMEM:
            break  # shared bytes grow with the rows: no larger block fits either
        for nt in (64, 128):
            for kt in (128, 64):
                if kt + 16 < nt or block_smem(H, W, M, R, G, nt, kt) > MAX_SMEM:
                    continue
                plan = make_plan(B, H, W, C, M, R, G, nt, kt)
                key = (plan_cost(plan, H, W, C, M), plan.blocks)
                if best_key is None or key < best_key:
                    best, best_key = plan, key
    if best is None:
        raise ValueError(f"no band of one {W}-pixel image row with M={M} channels fits in "
                         f"{MAX_SMEM} bytes of shared memory")
    return best


def make_plan(B: int, H: int, W: int, C: int, M: int, rows: int, images: int, nt: int,
              kt: int) -> BlockPlan:
    """A BlockPlan of the given cut, with its shared bytes, block count and
    copy width filled in (block_plan's choice, or a test's)."""
    return BlockPlan(rows, images, nt, kt, block_smem(H, W, M, rows, images, nt, kt),
                     -(-B // images) * -(-H // rows), 16 if C % 16 == 0 and M % 16 == 0 else 8)


def block_ranges(plan: BlockPlan, B: int, H: int, W: int) -> Iterator[Tuple[int, int, int, int]]:
    """(o0, P2, i0, P1) of each block, as fused_block.cu::block_rows cuts
    them: output rows [o0, o0 + P2) of the carry and stage-1 rows
    [i0, i0 + P1), the output rows and the halo rows inside their image."""
    nbands = -(-H // plan.rows)
    for b in range(plan.blocks):
        img, y0 = b // nbands * plan.images, b % nbands * plan.rows
        rows, nimg = min(plan.rows, H - y0), min(plan.images, B - img)
        above, below = (W if y0 > 0 else 0), (W if y0 + rows < H else 0)
        o0, p2 = (img * H + y0) * W, ((nimg - 1) * H + rows) * W
        yield o0, p2, o0 - above, p2 + above + below


def _check_block(x, H, W, w1, w2, w3, rows):
    N, C = x.shape
    M = w1.shape[0]
    if H < 1 or W < 1 or N % (H * W):
        raise ValueError(f"{N} rows are not whole {H}x{W} images")
    if C % 8 or M % 8:
        raise ValueError(f"channel counts C={C} and M={M} must be multiples of 8")
    for name, t, shape in (("w1", w1, (M, C)), ("w2", w2, (M, 9 * M)), ("w3", w3, (C, M))):
        _check_shape(name, t, shape)
    for name, t, n in zip(("sc1", "b1", "sc2", "b2", "sc3", "b3"), rows, (M, M, M, M, C, C)):
        _check_shape(name, t, (n,))
    _check_device(("w1", "w2", "w3", "sc1", "b1", "sc2", "b2", "sc3", "b3"),
                  (w1, w2, w3, *rows), x.device)


def _launch_block(plan: BlockPlan, x, H, W, w1, w2, w3, rows, s2, s3, s_in, s_out):
    """Kernel 5 under plan on checked CUDA tensors; returns out. Raises if
    the launch fails (cudaErrorInvalidValue for a plan the kernel refuses)."""
    from adaptive_tpu_torch.ops.cuda import build

    N, C = x.shape
    out = torch.empty_like(x)
    lib = build.load()
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = lib.bottleneck_block_launch(
            *map(_ptr, (x, w1, w2, w3, *rows, out)),
            *map(ctypes.c_float, (s2, s3, s_in, s_out)),
            N // (H * W), H, W, C, w1.shape[0], plan.rows, plan.images, plan.nt, plan.kt,
            plan.smem, plan.vec, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    _raise_on(err, "bottleneck_identity_int8")
    return out


def bottleneck_identity_int8(x, H: int, W: int, w1, w2, w3, sc1, b1, sc2, b2, sc3, b3,
                             s2: float, s3: float, s_in: float, s_out: float):
    """The fused identity bottleneck block (arguments as the twin's).
    Launches the CUDA kernel for CUDA tensors; runs the plain twin for CPU
    tensors."""
    rows = (sc1, b1, sc2, b2, sc3, b3)
    _check_block(x, H, W, w1, w2, w3, rows)
    if x.device.type == "cpu":
        return bottleneck_identity_int8_plain(x, H, W, w1, w2, w3, *rows, s2, s3, s_in, s_out)
    if x.device.type != "cuda":
        raise ValueError(f"bottleneck_identity_int8 runs on cuda or cpu, not {x.device}")
    _check_cuda(("x", "w1", "w2", "w3"), (x, w1, w2, w3), torch.int8, x.device)
    _check_cuda(("sc1", "b1", "sc2", "b2", "sc3", "b3"), rows, torch.float32, x.device)
    N, C = x.shape
    out = _launch_block(block_plan(N // (H * W), H, W, C, w1.shape[0]), x, H, W, w1, w2, w3,
                        rows, s2, s3, s_in, s_out)
    bottleneck_identity_int8.launches += 1
    return out


bottleneck_identity_int8.launches = 0
