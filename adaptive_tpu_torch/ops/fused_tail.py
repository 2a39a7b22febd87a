"""Fused bottleneck tail + next block's conv1 on the int8 carry, with its
plain twin (counterpart of adaptive_tpu/ops/pallas/fused_tail.py).

For a pair of adjacent blocks (i, i+1), block i an identity bottleneck:

    out_i   = requant(relu(conv3_i(z2_i) * sc3 + b3 + x_i * s_in), s_out)
    z1_next = requant(relu(conv1_{i+1}(out_i) * sc1 + b1), s_next)

Both convolutions are 1x1, so both are row-wise products over the carry
viewed as [N, C] rows (N = B*H*W): no image structure. Weights are s8, output
channel first: w3 [C, M], w1 [M2, C]; sc*/b* fp32 per output channel;
s_in, s_out, s_next the static scales (Python floats).

``tail_conv1_int8`` launches the CUDA kernel (ops/cuda/csrc/fused_tail.cu)
for CUDA tensors and counts it in ``tail_conv1_int8.launches``; for CPU
tensors it runs ``tail_conv1_int8_plain``, the same arithmetic as separate
IEEE operations, which the kernel reproduces bit for bit.

The kernel is bound by its bytes in every layer of ResNet-152 (x and z2
read, out and z1 written: 0.153 ms in layer3 at batch 1,024 at 3.35 TB/s).
A block owns ``tail_plan``'s rows and runs both products on kernel 5's ring
of shared-memory weight chunks (ops/fused_block.py), its z2 rows and the
new carry held in shared memory, two blocks an SM where their shared bytes
fit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Iterator, NamedTuple, Tuple

import torch

from adaptive_tpu_torch.ops.fused_block import (
    MAX_SMEM, RING_PASS, RING_STAGES, TWO_BLOCK_GAIN, TWO_BLOCK_SMEM, _act_ld, _stage_cost,
)
from adaptive_tpu_torch.ops.fused_step import (
    _check_cuda, _check_device, _check_runs_on, _check_shape, _ptr, _raise_on, define_op,
)
from adaptive_tpu_torch.ops.int8 import f32, int_mm, requant


def tail_conv1_int8_plain(x, z2, w3, sc3, b3, w1, sc1, b1, s_in: float, s_out: float,
                          s_next: float):
    """Plain twin: (out [N, C] s8, z1_next [N, M2] s8)."""
    tail = int_mm(z2, w3.t()).float() * sc3 + b3
    out = requant(torch.relu(tail + x.float() * f32(s_in, x)), s_out)
    z1 = torch.relu(int_mm(out, w1.t()).float() * sc1 + b1)
    return out, requant(z1, s_next)


# tail_cost's constants, kernel 5's model (fused_block._stage_cost,
# TWO_BLOCK_GAIN) refitted to kernel 6's plan sweep on an H100
# (tools/torch_int8_probe.py --kernels 6 --sweep, PERF.md): the fixed cost
# of a ring step and of a block in multiply-adds of the block
TAIL_STEP_MACS = 600e3
TAIL_BLOCK_MACS = 2e6


class TailPlan(NamedTuple):
    rows: int  # carry rows a block: a multiple of 16 (the last block ragged)
    nt: int  # output columns of a ring chunk: 64 (passes of 256 rows) or 128 (128 rows)
    kt: int  # K bytes of a ring chunk: 64 or 128 (kt + 16 >= nt: a residual tile row fits a ring row)
    smem: int  # shared bytes of a block
    blocks: int
    vec: int  # bytes a copy: 16 where C, M and M2 are multiples of 16, else 8

    @property
    def sms(self) -> int:
        """Blocks an SM: 2 where the shared bytes fit TWO_BLOCK_SMEM, else 1."""
        return 2 if self.smem <= TWO_BLOCK_SMEM else 1


def tail_smem(C: int, M: int, rows: int, nt: int, kt: int) -> int:
    """Shared bytes of a block, as fused_tail.cu::tail_smem lays them out:
    z2 [rows, act_ld(M)], the carry [rows, act_ld(C)], and the ring of
    RING_STAGES slots, each an nt-row weight chunk and up to a pass of rows,
    kt + 16 bytes a row."""
    return (rows * (_act_ld(M) + _act_ld(C))
            + RING_STAGES * (nt + min(rows, RING_PASS[nt])) * (kt + 16))


def make_tail_plan(N: int, C: int, M: int, M2: int, rows: int, nt: int, kt: int) -> TailPlan:
    """A TailPlan of the given rows and chunks, with its shared bytes, block
    count and copy width filled in (tail_plan's choice, or a test's)."""
    vec = 16 if C % 16 == 0 and M % 16 == 0 and M2 % 16 == 0 else 8
    return TailPlan(rows, nt, kt, tail_smem(C, M, rows, nt, kt), -(-N // rows), vec)


def tail_cost(plan: TailPlan, C: int, M: int, M2: int) -> float:
    """The model tail_plan minimises, kernel 5's (fused_block.plan_cost) on
    kernel 6's two stages with its own constants: blocks x (TAIL_BLOCK_MACS
    + conv3's and conv1's cost of a full block), over TWO_BLOCK_GAIN where
    two blocks share an SM."""
    per_block = (TAIL_BLOCK_MACS
                 + _stage_cost(plan.rows, plan.nt, plan.kt, C, 1, M, TAIL_STEP_MACS)
                 + _stage_cost(plan.rows, plan.nt, plan.kt, M2, 1, C, TAIL_STEP_MACS))
    return plan.blocks * per_block / (TWO_BLOCK_GAIN if plan.sms == 2 else 1.0)


@functools.lru_cache(maxsize=64)
def tail_plan(N: int, C: int, M: int, M2: int) -> TailPlan:
    """How kernel 6 cuts N carry rows into blocks: the plan of least
    tail_cost among row counts (multiples of 16, up to N rounded up),
    column chunks (64, 128) and K chunks (64, 128; 64 only with a column
    chunk of 64) whose shared bytes fit, two blocks an SM where they fit
    TWO_BLOCK_SMEM; ties go to fewer blocks. A block holds its z2 rows and
    its carry in shared memory beside the ring, so rows cost shared bytes;
    more rows a block mean fewer weight bytes from L2 and fuller warp
    tiles; two blocks an SM hide each other's latencies. Raises ValueError
    where not 16 rows fit."""
    best, best_key = None, None
    for rows in range(16, -(-N // 16) * 16 + 1, 16):
        if tail_smem(C, M, rows, 64, 64) > MAX_SMEM:
            break  # shared bytes grow with the rows: no larger block fits either
        for nt in (64, 128):
            for kt in (128, 64):
                if kt + 16 < nt or tail_smem(C, M, rows, nt, kt) > MAX_SMEM:
                    continue
                plan = make_tail_plan(N, C, M, M2, rows, nt, kt)
                key = (tail_cost(plan, C, M, M2), plan.blocks)
                if best_key is None or key < best_key:
                    best, best_key = plan, key
    if best is None:
        raise ValueError(f"no block of 16 rows with C={C}, M={M} channels fits in {MAX_SMEM} "
                         "bytes of shared memory")
    return best


def tail_ranges(plan: TailPlan, N: int) -> Iterator[Tuple[int, int]]:
    """(r0, rows) of each block, as fused_tail.cu cuts them: carry rows
    [r0, r0 + rows), the last block ragged."""
    for b in range(plan.blocks):
        yield b * plan.rows, min(plan.rows, N - b * plan.rows)


def _launch_tail(plan: TailPlan, x, z2, w3, sc3, b3, w1, sc1, b1, s_in, s_out, s_next):
    """Kernel 6 under plan on checked CUDA tensors; returns (out, z1).
    Raises if the launch fails (cudaErrorInvalidValue for a plan the kernel
    refuses)."""
    from adaptive_tpu_torch.ops.cuda import build

    N, C = x.shape
    M2 = w1.shape[0]
    out = torch.empty_like(x)
    z1 = torch.empty((N, M2), dtype=torch.int8, device=x.device)
    lib = build.load()
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = lib.tail_conv1_launch(
            *map(_ptr, (x, z2, w3, sc3, b3, w1, sc1, b1, out, z1)),
            *map(ctypes.c_float, (s_in, s_out, s_next)),
            N, C, z2.shape[1], M2, plan.rows, plan.nt, plan.kt, plan.smem, plan.vec,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    _raise_on(err, "tail_conv1_int8")
    return out, z1


def tail_conv1_int8(x, z2, w3, sc3, b3, w1, sc1, b1, s_in: float, s_out: float,
                    s_next: float):
    """The fused tail + conv1 pair (arguments as the twin's). Launches the
    CUDA kernel under tail_plan's plan for CUDA tensors; runs the plain
    twin for CPU tensors; under a tracer it calls the operator
    adaptive_tpu_torch::tail_conv1_int8 (ops/fused_step.py::define_op)."""
    N, C = x.shape
    M, M2 = z2.shape[1], w1.shape[0]
    if C % 8 or M % 8 or M2 % 8:
        raise ValueError(f"channel counts C={C}, M={M}, M2={M2} must be multiples of 8")
    for name, t, shape in (("z2", z2, (N, M)), ("w3", w3, (C, M)), ("sc3", sc3, (C,)),
                           ("b3", b3, (C,)), ("w1", w1, (M2, C)), ("sc1", sc1, (M2,)),
                           ("b1", b1, (M2,))):
        _check_shape(name, t, shape)
    _check_device(("z2", "w3", "sc3", "b3", "w1", "sc1", "b1"), (z2, w3, sc3, b3, w1, sc1, b1),
                  x.device)
    _check_runs_on("tail_conv1_int8", x.device)
    return tuple(_tail_op(x, z2, w3, sc3, b3, w1, sc1, b1, s_in, s_out, s_next))


def _tail_cuda(x, z2, w3, sc3, b3, w1, sc1, b1, s_in, s_out, s_next):
    N, C = x.shape
    M, M2 = z2.shape[1], w1.shape[0]
    _check_cuda(("x", "z2", "w3", "w1"), (x, z2, w3, w1), torch.int8, x.device)
    _check_cuda(("sc3", "b3", "sc1", "b1"), (sc3, b3, sc1, b1), torch.float32, x.device)
    out, z1 = _launch_tail(tail_plan(N, C, M, M2), x, z2, w3, sc3, b3, w1, sc1, b1, s_in,
                           s_out, s_next)
    tail_conv1_int8.launches += 1
    return out, z1


def _tail_fake(x, z2, w3, sc3, b3, w1, *rest):
    return torch.empty_like(x), x.new_empty((x.shape[0], w1.shape[0]))


_tail_op = define_op(
    "tail_conv1_int8(Tensor x, Tensor z2, Tensor w3, Tensor sc3, Tensor b3, Tensor w1, "
    "Tensor sc1, Tensor b1, float s_in, float s_out, float s_next) -> (Tensor, Tensor)",
    tail_conv1_int8_plain, _tail_cuda, _tail_fake)
tail_conv1_int8.launches = 0
