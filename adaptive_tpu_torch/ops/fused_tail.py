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
"""

from __future__ import annotations

import ctypes

import torch

from adaptive_tpu_torch.ops.fused_step import (
    _check_cuda, _check_device, _check_shape, _ptr, _raise_on,
)
from adaptive_tpu_torch.ops.int8 import f32, int_mm, requant


def tail_conv1_int8_plain(x, z2, w3, sc3, b3, w1, sc1, b1, s_in: float, s_out: float,
                          s_next: float):
    """Plain twin: (out [N, C] s8, z1_next [N, M2] s8)."""
    tail = int_mm(z2, w3.t()).float() * sc3 + b3
    out = requant(torch.relu(tail + x.float() * f32(s_in, x)), s_out)
    z1 = torch.relu(int_mm(out, w1.t()).float() * sc1 + b1)
    return out, requant(z1, s_next)


def tail_conv1_int8(x, z2, w3, sc3, b3, w1, sc1, b1, s_in: float, s_out: float,
                    s_next: float):
    """The fused tail + conv1 pair (arguments as the twin's). Launches the
    CUDA kernel for CUDA tensors; runs the plain twin for CPU tensors."""
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
    if x.device.type == "cpu":
        return tail_conv1_int8_plain(x, z2, w3, sc3, b3, w1, sc1, b1, s_in, s_out, s_next)
    if x.device.type != "cuda":
        raise ValueError(f"tail_conv1_int8 runs on cuda or cpu, not {x.device}")
    from adaptive_tpu_torch.ops.cuda import build

    _check_cuda(("x", "z2", "w3", "w1"), (x, z2, w3, w1), torch.int8, x.device)
    _check_cuda(("sc3", "b3", "sc1", "b1"), (sc3, b3, sc1, b1), torch.float32, x.device)
    out = torch.empty_like(x)
    z1 = torch.empty((N, M2), dtype=torch.int8, device=x.device)
    lib = build.load()
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = lib.tail_conv1_launch(
            *map(_ptr, (x, z2, w3, sc3, b3, w1, sc1, b1, out, z1)),
            *map(ctypes.c_float, (s_in, s_out, s_next)),
            N, C, M, M2, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    _raise_on(err, "tail_conv1_int8")
    tail_conv1_int8.launches += 1
    return out, z1


tail_conv1_int8.launches = 0
