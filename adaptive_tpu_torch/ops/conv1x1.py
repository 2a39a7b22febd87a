"""A stride-1 1x1 convolution of the BN-folded bf16 encoder with its
epilogue, as one GEMM over the NHWC rows, with its plain twin. It replaces
no kernel of the JAX package: there XLA fused the convolution with its
bias, residual add and relu.

``conv1x1_epilogue(x, w, bias, residual, residual_bias)`` computes, for x
[..., K] and the folded kernel w [N, K, 1, 1] (or [N, K]),

    y = relu((x w^T + bias) + r),  r = 0 | residual | (residual + residual_bias)

with the product summed in fp32 and the epilogue of
ops/conv_epilogue.py::folded_epilogue applied to it before the one rounding
to x's dtype; y [..., N] is a new tensor. The float encoder
(models/infer.py::resnet_apply_folded) calls it for the conv1 (bias + relu)
and conv3 (+ the block input, or + the downsample's raw output and its
bias) of every bottleneck when the activation is bf16: 100 calls a
ResNet-152 encode.

For CUDA tensors the wrapper checks dtype (bfloat16 only: in fp32 the
tensor cores would take TF32), device, contiguity, 16-byte alignment and K
and N (multiples of 64), raises on anything else, launches kernel 9
(ops/cuda/csrc/conv1x1_epilogue.cu) and counts it in
``conv1x1_epilogue.launches``. For CPU tensors it runs the twin
``conv1x1_epilogue_plain``. The pair is the operator
``adaptive_tpu_torch::conv1x1_epilogue`` (ops/fused_step.py::define_op), so
that an exported encoder (export.py) records it.

The kernel is mostly bound by its bytes: at batch 1,024 a ResNet-152
encode's 100 launches move 95.5 GB (x, w, the residual and y once each),
28.5 ms at 3.35 TB/s, and hold 10.8 TFLOP, 10.9 ms at 989 TFLOP/s.
"""

from __future__ import annotations

import ctypes

import torch

from adaptive_tpu_torch.ops import conv_epilogue as CE
from adaptive_tpu_torch.ops.fused_step import (
    _check_cuda, _check_device, _check_runs_on, _check_shape, _ptr, _raise_on, define_op,
)

ALIGN = 64  # K and N the kernel takes: multiples of its 64-wide k-blocks and output boxes


def _weight_2d(w, K):
    """The folded kernel as [N, K]; raises unless it is [N, K] or [N, K, 1, 1]."""
    if w.dim() == 4 and tuple(w.shape[1:]) == (K, 1, 1):
        return w.reshape(w.shape[0], K)
    if w.dim() == 2 and w.shape[1] == K:
        return w
    raise ValueError(f"w has shape {tuple(w.shape)}, expected [N, {K}, 1, 1] or [N, {K}]")


def conv1x1_epilogue_plain(x, w, bias, residual=None, residual_bias=None):
    """Plain twin: the product in fp32, then folded_epilogue_plain's
    epilogue, one cast to x's dtype; a new tensor [..., N]."""
    K = x.shape[-1]
    w2 = _weight_2d(w, K)
    acc = (x.reshape(-1, K).float() @ w2.float().T).reshape(*x.shape[:-1], w2.shape[0])
    return CE.folded_epilogue_plain(acc, bias, residual, residual_bias).to(x.dtype)


def conv1x1_epilogue(x, w, bias, residual=None, residual_bias=None):
    """relu((x w^T + bias) + r) for x [..., K], w [N, K, 1, 1] or [N, K]:
    r is 0, residual ([..., N]) or residual + residual_bias; bias and
    residual_bias [N]. Kernel 9 for CUDA tensors, the plain twin for CPU
    ones; under a tracer the operator adaptive_tpu_torch::conv1x1_epilogue."""
    K = x.shape[-1]
    N = _weight_2d(w, K).shape[0]
    _check_shape("bias", bias, (N,))
    if residual is not None:
        _check_shape("residual", residual, (*x.shape[:-1], N))
    if residual_bias is not None:
        if residual is None:
            raise ValueError("residual_bias is the residual's bias: it needs a residual")
        _check_shape("residual_bias", residual_bias, (N,))
    named = [(n, t) for n, t in (("w", w), ("bias", bias), ("residual", residual),
                                 ("residual_bias", residual_bias)) if t is not None]
    _check_device(*zip(*named), x.device)
    _check_runs_on("conv1x1_epilogue", x.device)
    return _conv1x1_op(x, w, bias, residual, residual_bias)


def _conv1x1_cpu(x, w, bias, residual, residual_bias):
    return conv1x1_epilogue_plain(x, w, bias, residual, residual_bias)


def _conv1x1_cuda(x, w, bias, residual, residual_bias):
    dt = x.dtype
    if dt != torch.bfloat16:
        raise ValueError(f"conv1x1_epilogue takes bfloat16, not {dt}")
    K = x.shape[-1]
    w2 = _weight_2d(w, K)
    N = w2.shape[0]
    if K % ALIGN or N % ALIGN:
        raise ValueError(f"conv1x1_epilogue needs K and N multiples of {ALIGN}, got K={K}, N={N}")
    named = [(n, t) for n, t in (("x", x), ("w", w2), ("bias", bias), ("residual", residual),
                                 ("residual_bias", residual_bias)) if t is not None]
    _check_cuda(*zip(*named), dt, x.device)
    from adaptive_tpu_torch.ops.cuda import build

    lib = build.load()
    y = torch.empty((*x.shape[:-1], N), dtype=dt, device=x.device)
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = lib.conv1x1_epilogue_launch(
            *map(_ptr, (x, w2, bias, residual, residual_bias, y)), x.numel() // K, K, N,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _raise_on(err, "conv1x1_epilogue")
    conv1x1_epilogue.launches += 1
    return y


def _conv1x1_fake(x, w, *rest):
    return x.new_empty((*x.shape[:-1], w.shape[0]))


def launch_plan(M: int, K: int, N: int, residual: bool, device=None) -> dict:
    """The launch plan kernel 9 takes for x [M, K] and w [N, K], with or
    without a residual, on the card (ops/cuda/csrc/conv1x1_epilogue.cu::
    plan): tile columns, whether W stays resident in shared memory, ring
    stages, shared bytes, epilogue buffers."""
    from adaptive_tpu_torch.ops.cuda import build

    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device or torch.cuda.current_device()):
        err = build.load().conv1x1_epilogue_plan(M, K, N, int(residual), out)
    _raise_on(err, "conv1x1_epilogue_plan")
    return dict(zip(("tile_n", "w_resident", "stages", "smem_bytes", "buffers"), out))


_conv1x1_op = define_op(
    "conv1x1_epilogue(Tensor x, Tensor w, Tensor bias, Tensor? residual, "
    "Tensor? residual_bias) -> Tensor",
    _conv1x1_cpu, _conv1x1_cuda, _conv1x1_fake)
conv1x1_epilogue.launches = 0
