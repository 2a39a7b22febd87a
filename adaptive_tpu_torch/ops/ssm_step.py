"""Kernel 8: one decode step of a Mamba-2 layer for every row of a batch
(models/hybrid_lm.py), with its plain twin. It replaces no kernel of the JAX
package, which has no state-space model; it is the decode's largest
traffic: granite-4.0-h-micro holds 36 MiB of SSM state a caption.

For each row, from the step's raw in_proj slices xbc [B, C] and dt [B, H]:

    w      = [conv_state, xbc]                      (the last d_conv raw inputs)
    xbc'   = silu(conv_b + sum_k conv_w[:, k] w_k)  -> x [H, P], B and C [G, N]
    dt'    = softplus(dt + dt_bias),  dA = exp(dt' A)
    S_h    = dA_h S_h + (dt'_h x_h) B_g^T           (head h in group g = h / (H / G))
    y_h    = S_h C_g + D_h x_h

conv_state [B, d_conv - 1, C] shifts by one input and the state [B, H, P,
N] is updated, both in place; y [B, H * P] is returned in xbc's dtype. All
arithmetic is fp32; the state and y are rounded once to their dtype.

For CUDA tensors the wrapper checks devices, dtypes (xbc, dt, conv_state,
conv_w, conv_b and state of one dtype, float32 or bfloat16; dt_bias, A and
D float32), shapes and contiguity (xbc's and dt's rows may be strided, their
elements not), raises on anything else, launches the kernel
(ops/cuda/csrc/ssm_step.cu) and counts it in ``ssm_step.launches``. For CPU
tensors it runs the twin ``ssm_step_plain``.

The kernel is bound by its bytes: at batch 1,024 and granite-4.0-h-micro's
widths a launch reads and writes 1.07 GB of bf16 state and 27 MB of conv
state, 0.66 ms at 3.35 TB/s (benchmark/lib/hybrid.py::ssm_step_work).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from adaptive_tpu_torch.ops.fused_step import (
    _DTYPE_CODE, _check_device, _check_runs_on, _check_shape, _ptr, _raise_on,
)

MAX_CONV = 4  # d_conv at most (ssm_step.cu SSM_MAX_CONV)
SMEM_LIMIT = 232448  # bytes of shared memory a block can use (the activated row)


def _sizes(xbc, dt, state):
    """(B, C, H, P, N, G) from the operands' shapes; raises where C is not
    H * P + 2 * G * N for a G that divides H."""
    if xbc.dim() != 2 or dt.dim() != 2 or state.dim() != 4:
        raise ValueError(f"ssm_step takes xbc [B, C], dt [B, H] and state [B, H, P, N], got "
                         f"{tuple(xbc.shape)}, {tuple(dt.shape)}, {tuple(state.shape)}")
    B, C = xbc.shape
    _, H, P, N = state.shape
    g2 = C - H * P
    if g2 <= 0 or g2 % (2 * N) or H % (g2 // (2 * N)):
        raise ValueError(f"xbc's width {C} is not H * P + 2 * G * N for H={H}, P={P}, N={N} "
                         "and a G that divides H")
    return B, C, H, P, N, g2 // (2 * N)


def ssm_step_plain(xbc, dt, conv_state, conv_w, conv_b, dt_bias, A, D, state):
    """Plain twin: (y [B, H * P], the shifted conv state, the new state) as
    new tensors, fp32 inside, each rounded once to its input's dtype."""
    B, C, H, P, N, G = _sizes(xbc, dt, state)
    win = torch.cat([conv_state.float(), xbc.float()[:, None]], dim=1)  # [B, K, C]
    xa = F.silu(conv_b.float() + (win * conv_w.float().T[None]).sum(1))
    x, Bm, Cm = xa.split([H * P, G * N, G * N], dim=-1)
    d = F.softplus(dt.float() + dt_bias)
    dA = torch.exp(d * A)
    Bh = Bm.reshape(B, G, N).repeat_interleave(H // G, dim=1)[:, :, None, :]
    Ch = Cm.reshape(B, G, N).repeat_interleave(H // G, dim=1)[:, :, None, :]
    xh = x.reshape(B, H, P)
    S = dA[:, :, None, None] * state.float() + (d[:, :, None] * xh)[..., None] * Bh
    y = (S * Ch).sum(-1) + D[:, None] * xh
    return (y.reshape(B, H * P).to(xbc.dtype), win[:, 1:].to(conv_state.dtype),
            S.to(state.dtype))


def ssm_step(xbc, dt, conv_state, conv_w, conv_b, dt_bias, A, D, state):
    """One decode step: y [B, H * P] returned, conv_state [B, d_conv - 1, C]
    and state [B, H, P, N] updated in place (module docstring). The CUDA
    kernel for CUDA tensors, the plain twin for CPU ones."""
    B, C, H, P, N, G = _sizes(xbc, dt, state)
    K = conv_w.shape[-1]
    _check_shape("dt", dt, (B, H))
    _check_shape("conv_state", conv_state, (B, K - 1, C))
    _check_shape("conv_w", conv_w, (C, K))
    _check_shape("conv_b", conv_b, (C,))
    for name, t in (("dt_bias", dt_bias), ("A", A), ("D", D)):
        _check_shape(name, t, (H,))
    names = ("xbc", "dt", "conv_state", "conv_w", "conv_b", "dt_bias", "A", "D", "state")
    tensors = (xbc, dt, conv_state, conv_w, conv_b, dt_bias, A, D, state)
    _check_device(names, tensors, xbc.device)
    _check_runs_on("ssm_step", xbc.device)
    for name, t in zip(names, tensors):
        if name in ("xbc", "dt"):
            if t.stride(-1) != 1:
                raise ValueError(f"{name}'s elements must be contiguous (stride 1), got "
                                 f"strides {t.stride()}")
        elif not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dtype = xbc.dtype
    for name, t in zip(names, tensors):
        want = torch.float32 if name in ("dt_bias", "A", "D") else dtype
        if t.dtype != want:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {want}")
    if not xbc.is_cuda:
        y, cs, S = ssm_step_plain(*tensors)
        conv_state.copy_(cs)
        state.copy_(S)
        return y
    return _launch(xbc, dt, conv_state, conv_w, conv_b, dt_bias, A, D, state, B, C, H, P, N, G, K)


def _launch(xbc, dt, conv_state, conv_w, conv_b, dt_bias, A, D, state, B, C, H, P, N, G, K):
    dtype = xbc.dtype
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"ssm_step takes float32 or bfloat16, not {dtype}")
    lanes = 16 // state.element_size()
    if N % lanes or (N // lanes) & (N // lanes - 1) or N // lanes > 32:
        raise ValueError(f"ssm_step in {dtype} needs d_state a power-of-two multiple of "
                         f"{lanes}, at most {32 * lanes}, got {N}")
    if (H * P) % 4:
        raise ValueError(f"ssm_step needs H * P a multiple of 4, got {H * P}")
    if not 2 <= K <= MAX_CONV:
        raise ValueError(f"ssm_step takes d_conv 2..{MAX_CONV}, got {K}")
    if (C + 2 * H) * 4 > SMEM_LIMIT:
        raise ValueError(f"ssm_step: a row's {C} channels exceed a block's shared memory")
    if state.data_ptr() % 16:
        raise ValueError("state must be 16-byte aligned")
    from adaptive_tpu_torch.ops.cuda import build

    lib = build.load()
    y = torch.empty((B, H * P), dtype=dtype, device=xbc.device)
    with torch.cuda.device(xbc.device):  # the launch goes to the current device
        err = lib.ssm_step_launch(
            _DTYPE_CODE[dtype], _ptr(xbc), xbc.stride(0), _ptr(dt), dt.stride(0),
            *map(_ptr, (conv_state, conv_w, conv_b, dt_bias, A, D, state, y)),
            B, C, K, H, P, N, G, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _raise_on(err, "ssm_step")
    ssm_step.launches += 1
    return y


ssm_step.launches = 0
