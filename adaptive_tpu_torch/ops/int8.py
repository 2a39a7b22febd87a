"""Integer pieces of the int8 encoder: the int8 matrix product, im2col over
NHWC rows, and the fp32 -> s8 requantisation, shared by models/infer.py and
the plain twins of the fused int8 kernels (ops/fused_block.py,
ops/fused_tail.py).

Every division here is a true IEEE division. CUDA's PyTorch turns a division
by a Python scalar into a product with its reciprocal, which can move a
requant rounding tie, so a scalar divisor is made a 0-dim tensor on the
operand's device first (``true_div``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def f32(v, like: torch.Tensor) -> torch.Tensor:
    """v (Python float, numpy array or tensor) as fp32 on like's device. A
    Python float is rounded to fp32 once, as a JAX weak-typed scalar is."""
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=torch.float32)
    if isinstance(v, (int, float)):
        return torch.full((), float(v), dtype=torch.float32, device=like.device)
    return torch.as_tensor(v, dtype=torch.float32).to(like.device)


def true_div(a: torch.Tensor, b) -> torch.Tensor:
    return a / f32(b, a)


def requant(y: torch.Tensor, scale) -> torch.Tensor:
    """fp32 -> s8 with a static scale: clamp(round(y / s), -127, 127), round
    half to even (as jnp.round)."""
    return torch.clamp(torch.round(true_div(y, scale)), -127, 127).to(torch.int8)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [N, K] s8 @ b [K, O] s8 -> [N, O] int32, exact (int32
    accumulation). torch._int_mm's CUDA path takes more than 16 rows and K
    and O multiples of 8, so the operands are padded with zeros to that,
    which adds nothing to any sum, and the result is cut back."""
    N, K = a.shape
    O = b.shape[1]
    kp, op, rp = (-K) % 8, (-O) % 8, max(0, 17 - N)
    if kp or rp:
        a = F.pad(a, (0, kp, 0, rp))
    if kp or op:
        b = F.pad(b, (0, op, 0, kp))
    out = torch._int_mm(a, b)
    return out[:N, :O] if (op or rp) else out


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int, pad) -> torch.Tensor:
    """NHWC [B, H, W, C] -> rows [B * Ho * Wo, kh * kw * C]: the zero-padded
    input's kh x kw window at each output position, columns in (ky, kx, c)
    order (the OHWI weight's). pad = ((top, bottom), (left, right))."""
    (pt, pb), (pl, pr) = pad
    if kh == kw == 1 and not (pt or pb or pl or pr):
        x = x[:, ::stride, ::stride] if stride > 1 else x
        return x.reshape(-1, x.shape[-1])
    B, H, W, C = x.shape
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    Ho = (H + pt + pb - kh) // stride + 1
    Wo = (W + pl + pr - kw) // stride + 1
    cols = [xp[:, ky:ky + stride * (Ho - 1) + 1:stride, kx:kx + stride * (Wo - 1) + 1:stride]
            for ky in range(kh) for kx in range(kw)]
    return torch.cat(cols, dim=-1).reshape(B * Ho * Wo, kh * kw * C)


def wmat(wq: torch.Tensor) -> torch.Tensor:
    """OIHW s8 kernel -> [O, kh * kw * I] rows in (ky, kx, i) order: a view
    when the kernel is stored channels_last (OHWI), as folded kernels are."""
    return wq.permute(0, 2, 3, 1).reshape(wq.shape[0], -1)
