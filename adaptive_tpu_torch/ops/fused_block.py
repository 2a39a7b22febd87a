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
"""

from __future__ import annotations

import ctypes

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
    from adaptive_tpu_torch.ops.cuda import build

    _check_cuda(("x", "w1", "w2", "w3"), (x, w1, w2, w3), torch.int8, x.device)
    _check_cuda(("sc1", "b1", "sc2", "b2", "sc3", "b3"), rows, torch.float32, x.device)
    N, C = x.shape
    out = torch.empty_like(x)
    lib = build.load()
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = lib.bottleneck_block_launch(
            *map(_ptr, (x, w1, w2, w3, *rows, out)),
            *map(ctypes.c_float, (s2, s3, s_in, s_out)),
            N // (H * W), H, W, C, w1.shape[0],
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    _raise_on(err, "bottleneck_identity_int8")
    bottleneck_identity_int8.launches += 1
    return out


bottleneck_identity_int8.launches = 0
