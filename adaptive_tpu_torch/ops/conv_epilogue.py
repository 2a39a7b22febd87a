"""The epilogue of the BN-folded float encoder's convolutions, with its
plain twin. It replaces no kernel of the JAX package: there XLA fused the
bias, residual add and relu into the convolutions.

Each convolution of models/infer.py::resnet_apply_folded runs without its
folded bias; ``folded_epilogue`` then makes one pass over its NHWC output
``acc`` [..., C]:

    y = relu((acc + bias) + r),  r = 0 | residual | (residual + residual_bias)

in fp32 with one rounding to acc's dtype, in the association of the
separate passes it replaces (the conv's bias add, the downsample's, z + sc,
relu), and writes y into acc, which it returns. The three users: the stem
and every conv1 / conv2 (bias + relu), an identity block's last conv (+ the
block input), a downsample block's last conv (+ the downsample's raw output
and its bias).

For CUDA tensors the wrapper checks dtype (float32 or bfloat16), device,
contiguity, 16-byte alignment and C (a multiple of 8 in bf16, 4 in fp32, at
most 512 16-byte groups), raises on anything else, launches the kernel
(ops/cuda/csrc/conv_epilogue.cu) and counts it in
``folded_epilogue.launches``. For CPU tensors it runs the twin
``folded_epilogue_plain``. The pair is the operator
``adaptive_tpu_torch::folded_epilogue`` (ops/fused_step.py::define_op), so
that an exported encoder (export.py) records it.

The kernel is bound by its bytes: at batch 1,024 a ResNet-152 encode makes
151 launches over 113 GB, 33.8 ms at 3.35 TB/s, where the separate passes
moved 259 GB.
"""

from __future__ import annotations

import ctypes

import torch

from adaptive_tpu_torch.ops.fused_step import (
    _DTYPE_CODE, _check_cuda, _check_device, _check_runs_on, _check_shape, _ptr, _raise_on,
    define_op,
)

MAX_GROUPS = 512  # 16-byte channel groups a row at most (conv_epilogue.cu EPI_MAX_GROUPS)


def folded_epilogue_plain(acc, bias, residual=None, residual_bias=None):
    """Plain twin: relu((acc + bias) + r) over the last dim, fp32 inside,
    one cast to acc's dtype; a new tensor."""
    y = acc.float() + bias.float()
    if residual is not None:
        r = residual.float()
        y = y + (r if residual_bias is None else r + residual_bias.float())
    return torch.relu(y).to(acc.dtype)


def folded_epilogue(acc, bias, residual=None, residual_bias=None):
    """relu((acc + bias) + r) written into acc [..., C], which is returned:
    r is 0, residual (acc's shape) or residual + residual_bias; bias and
    residual_bias [C]. The CUDA kernel for CUDA tensors, the plain twin for
    CPU ones; under a tracer the operator adaptive_tpu_torch::folded_epilogue."""
    C = acc.shape[-1]
    _check_shape("bias", bias, (C,))
    if residual is not None:
        _check_shape("residual", residual, acc.shape)
    if residual_bias is not None:
        if residual is None:
            raise ValueError("residual_bias is the residual's bias: it needs a residual")
        _check_shape("residual_bias", residual_bias, (C,))
    named = [(n, t) for n, t in (("bias", bias), ("residual", residual),
                                 ("residual_bias", residual_bias)) if t is not None]
    _check_device(*zip(*named), acc.device)
    _check_runs_on("folded_epilogue", acc.device)
    return _epilogue_op(acc, bias, residual, residual_bias)


def _epilogue_cpu(acc, bias, residual, residual_bias):
    return acc.copy_(folded_epilogue_plain(acc, bias, residual, residual_bias))


def _epilogue_cuda(acc, bias, residual, residual_bias):
    dt = acc.dtype
    if dt not in _DTYPE_CODE:
        raise ValueError(f"folded_epilogue takes float32 or bfloat16, not {dt}")
    C = acc.shape[-1]
    lanes = 16 // acc.element_size()
    if C % lanes or not 0 < C // lanes <= MAX_GROUPS:
        raise ValueError(f"folded_epilogue in {dt} needs C a multiple of {lanes} and at most "
                         f"{MAX_GROUPS * lanes}, got {C}")
    named = [(n, t) for n, t in (("acc", acc), ("bias", bias), ("residual", residual),
                                 ("residual_bias", residual_bias)) if t is not None]
    _check_cuda(*zip(*named), dt, acc.device)
    from adaptive_tpu_torch.ops.cuda import build

    lib = build.load()
    with torch.cuda.device(acc.device):  # the launch goes to the current device
        err = lib.folded_epilogue_launch(
            _DTYPE_CODE[dt], *map(_ptr, (acc, bias, residual, residual_bias)),
            acc.numel() // C, C, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _raise_on(err, "folded_epilogue")
    folded_epilogue.launches += 1
    return acc


def _epilogue_fake(acc, *rest):
    return torch.empty_like(acc)


_epilogue_op = define_op(
    "folded_epilogue(Tensor acc, Tensor bias, Tensor? residual, Tensor? residual_bias) -> Tensor",
    _epilogue_cpu, _epilogue_cuda, _epilogue_fake)
folded_epilogue.launches = 0
