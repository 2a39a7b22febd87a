"""Experimental quantised conv BACKWARD for the CNN fine-tune phase
(counterpart of adaptive_tpu/ops/quant_conv.py).

The forward conv stays exact (bf16/fp32, bit-identical in every mode); the
two backward contractions of a stride-1 conv swap to int8 with dynamic
per-tensor scales:

    dx = conv(g_q8, flip_hw(w_q8) with in and out swapped)
    dw = the batch-as-channel conv of x_q8 against g_q8

Strided convs keep autograd's exact backward, as in JAX.

Modes (``set_conv_bwd_quant``, a global switch read when a conv runs):
    'none'    autograd's exact backward (default; production path)
    'manual'  the hand-derived contractions in fp32, F.conv2d on flipped and
              transposed operands (not torch.nn.grad, which is autograd's
              own backward that this mode checks)
    'int8'    the experiment: the contractions as im2col rows times an int8
              matrix through ops/int8.py::int_mm (int32 counts), converted to
              fp32 and scaled by the product of the operands' scales

The entry point ``conv_nchw`` takes the port's layout, NCHW activations and
OIHW weights (models/resnet.py runs its trunk NCHW), where JAX's
``conv_nhwc`` takes NHWC/HWIO. Two deviations by design:

* dw contracts over K = B*H*W rows, where 127^2 * K can pass 2^31 - 1 (K =
  200,704 in ResNet-152's layer2 at batch 256). Its K is cut into chunks of
  at most DW_CHUNK rows whose int32 counts are summed in int64: equal to
  JAX's one int32 contraction wherever that does not wrap, and right where
  it would. dx contracts over kh*kw*Co <= 4,608 rows and cannot wrap.
* On a data-parallel group (``group``) a rank holds only its rows of x and
  g, where JAX's custom VJP sees the global arrays: their amax is a MAX
  all-reduce over the group, so every rank quantises with JAX's global
  scales; w is replicated. Each rank's scaled dw then enters the step's
  gradient all-reduce, whose sum equals JAX's global contraction to fp32
  rounding.

Every division is a true IEEE division by a 0-dim tensor on the operand's
device (ops/int8.py::true_div), so the round-half-to-even ties of ``_q8``
fall as JAX's do on the card too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from adaptive_tpu_torch.ops.int8 import f32, im2col, int_mm, true_div

_MODE = {"mode": "none"}
_MODES = ("none", "manual", "int8")
# the most rows an int32 dw count can sum without wrapping: each adds at
# most 127 * 127; a multiple of 8, as torch._int_mm's CUDA path takes K
DW_CHUNK = (2 ** 31 - 1) // 127 ** 2 // 8 * 8


def set_conv_bwd_quant(mode: str) -> None:
    if mode not in _MODES:
        raise ValueError(f"conv_bwd_quant={mode!r} — must be one of {_MODES}")
    _MODE["mode"] = mode


def get_conv_bwd_quant() -> str:
    return _MODE["mode"]


def conv_nchw(x: torch.Tensor, weight: torch.Tensor, stride: int = 1,
              group=None) -> torch.Tensor:
    """NCHW/OIHW conv with torch-style symmetric (k-1)//2 padding, in x's
    dtype; dispatches the backward per the mode. group: the data group whose
    ranks share the int8 scales (None: this process's tensors only)."""
    if _MODE["mode"] != "none" and stride == 1:
        return _ConvCustomBwd.apply(x, weight, _MODE["mode"] == "int8", group)
    return _plain(x, weight, stride)


def _plain(x, weight, stride=1):
    pad = (weight.shape[2] - 1) // 2
    return F.conv2d(x, weight.to(x.dtype), None, stride, pad)


def _amax(t: torch.Tensor) -> torch.Tensor:
    return t.float().abs().amax()


def _q8(t: torch.Tensor, amax=None):
    """Dynamic symmetric per-tensor int8: (values s8, scale fp32 0-dim).
    amax: the tensor's (default) or a group's, all-reduced by the caller."""
    tf = t.float()
    amax = tf.abs().amax() if amax is None else amax
    scale = true_div(torch.maximum(amax, f32(1e-8, amax)), 127.0)
    q = torch.clamp(torch.round(true_div(tf, scale)), -127, 127)
    return q.to(torch.int8), scale


def _pads(k: int):
    p = (k - 1) // 2
    return ((p, p), (p, p))


def dx_counts(gq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int32 [B, Ci, H, W]: dx[b,ci,h,w] = sum over (ky, kx, co) of
    g[b, co, h-ky+p, w-kx+p] w[co, ci, ky, kx], as im2col(g) [B*H*W,
    kh*kw*Co] times the flipped kernel [kh*kw*Co, Ci]."""
    Co, Ci, kh, kw = wq.shape
    B, _, H, W = gq.shape
    cols = im2col(gq.permute(0, 2, 3, 1), kh, kw, 1, _pads(kh))
    wt = wq.flip(2, 3).permute(2, 3, 0, 1).reshape(kh * kw * Co, Ci)
    return int_mm(cols, wt).reshape(B, H, W, Ci).permute(0, 3, 1, 2)


def dw_counts(xq: torch.Tensor, gq: torch.Tensor, k: int) -> torch.Tensor:
    """[Co, Ci, k, k]: dw[co,ci,ky,kx] = sum over (b, h, w) of
    x[b, ci, h+ky-p, w+kx-p] g[b, co, h, w], as g's rows transposed [Co,
    B*H*W] times im2col(x) [B*H*W, k*k*Ci]. int32 where K = B*H*W fits one
    chunk, else the chunks' int32 counts summed in int64. The transposed
    rows are copied contiguous: on the H100 the copy and torch._int_mm
    take less time than torch._int_mm on the strided view (chip_smoke.py's
    phase 13a times both)."""
    Co, Ci = gq.shape[1], xq.shape[1]
    rows = gq.permute(0, 2, 3, 1).reshape(-1, Co)
    cols = im2col(xq.permute(0, 2, 3, 1), k, k, 1, _pads(k))
    N = rows.shape[0]
    if N <= DW_CHUNK:
        acc = int_mm(rows.t().contiguous(), cols)
    else:
        acc = sum(int_mm(rows[i:i + DW_CHUNK].t().contiguous(), cols[i:i + DW_CHUNK]).long()
                  for i in range(0, N, DW_CHUNK))
    return acc.reshape(Co, k, k, Ci).permute(0, 3, 1, 2)


def _manual_bwd(x, w, g, need_dx):
    p = (w.shape[2] - 1) // 2
    gf, wf, xf = g.float(), w.float(), x.float()
    dx = F.conv2d(gf, wf.flip(2, 3).transpose(0, 1), None, 1, p) if need_dx else None
    dw = F.conv2d(xf.transpose(0, 1), gf.transpose(0, 1), None, 1, p).transpose(0, 1)
    return dx, dw


def _int8_bwd(x, w, g, group, need_dx):
    amax_g, amax_x = _amax(g), _amax(x)
    if group is not None:
        from adaptive_tpu_torch.parallel.mesh import all_reduce_max_

        amaxes = torch.stack([amax_g, amax_x])
        all_reduce_max_([amaxes], group)
        amax_g, amax_x = amaxes[0], amaxes[1]
    gq, sg = _q8(g, amax_g)
    dx = None
    if need_dx:
        wq, sw = _q8(w)
        dx = dx_counts(gq, wq).float() * (sg * sw)
    xq, sx = _q8(x, amax_x)
    dw = dw_counts(xq, gq, w.shape[2]).float() * (sx * sg)
    return dx, dw


class _ConvCustomBwd(torch.autograd.Function):
    """The stride-1 conv: forward _plain, backward per the mode (JAX's
    custom_vjp _conv_custom_bwd)."""

    @staticmethod
    def forward(ctx, x, weight, use_int8, group):
        ctx.save_for_backward(x, weight)
        ctx.use_int8, ctx.group = use_int8, group
        return _plain(x, weight, 1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_dx = ctx.needs_input_grad[0]
        if ctx.use_int8:
            dx, dw = _int8_bwd(x, w, g, ctx.group, need_dx)
        else:
            dx, dw = _manual_bwd(x, w, g, need_dx)
        return (dx.to(x.dtype) if dx is not None else None), dw.to(w.dtype), None, None
