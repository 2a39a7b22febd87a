"""The two kernels of a greedy decode step, with their plain twins
(counterpart of adaptive_tpu/ops/pallas/fused_step.py, beam_w == 1).

* ``decode_cell``: LSTM recurrence + visual sentinel + adaptive attention,
  given the input projection gx = x @ W_ih + b_ih computed outside.
* ``greedy_head_argmax``: argmax over the real vocab of (chat + h) @ W + b,
  first max on ties, logits never stored.

Each wrapper launches its CUDA kernel (ops/cuda/csrc/fused_step.cu) for CUDA
tensors, after checking device, dtype, shape, contiguity and alignment, and
raises on anything the kernel does not take. For CPU tensors it runs the
plain PyTorch twin beside it, which is the arithmetic the kernel must
reproduce: fp32 inside, the same casts, the same -1e30 mask. Each wrapper
counts its kernel launches in a plain int attribute, ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

NEG = -1e30
HEAD_TILE = 128  # vocab columns per block of the head kernel (BN in the source)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check_cuda(names, tensors, dtype, device):
    for name, t in zip(names, tensors):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check_shape(name, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {err}")


# ----------------------------------------------------------------- decode cell
def decode_cell_plain(gx, h, c, x, hp, pv, V, whh, bhh, wx, whs, wg, ws, wh):
    """Plain twin of the cell kernel. gx [B,4H] fp32; h, c, hp [B,H]; x
    [B,E2]; pv [B,K,D]; V [B,K,H]; whh [H,4H]; bhh [4H]; wx [E2,H]; whs
    [H,H]; wg, ws [H,D]; wh [D]. Returns (h', c', c_hat) in h's dtype and
    (alpha [B,K], beta [B,1]) in fp32."""
    f = lambda t: t.float()  # noqa: E731
    gates = f(gx) + f(h) @ f(whh) + f(bhh)
    i, fg, g, o = torch.chunk(gates, 4, dim=-1)
    cell = torch.sigmoid(fg) * f(c) + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(cell)
    s = torch.sigmoid(f(x) @ f(wx) + f(hp) @ f(whs)) * torch.tanh(cell)
    ph = h_new @ f(wg)  # [B, D]
    z = (torch.tanh(f(pv) + ph[:, None, :]) * f(wh)).sum(-1)  # [B, K]
    z_s = (torch.tanh(s @ f(ws) + ph) * f(wh)).sum(-1, keepdim=True)  # [B, 1]
    m = z.amax(-1, keepdim=True)
    e = torch.exp(z - m)
    denom = e.sum(-1, keepdim=True)
    alpha = e / denom
    m2 = torch.maximum(m, z_s)
    beta = torch.exp(z_s - m2) / (denom * torch.exp(m - m2) + torch.exp(z_s - m2))
    ctx = torch.bmm(alpha[:, None, :], f(V))[:, 0]
    chat = beta * s + (1.0 - beta) * ctx
    dt = h.dtype
    return h_new.to(dt), cell.to(dt), chat.to(dt), alpha, beta


def decode_cell(gx, h, c, x, hp, pv, V, whh, bhh, wx, whs, wg, ws, wh):
    """One fused decode cell (arguments as decode_cell_plain). Launches the
    CUDA kernel for CUDA tensors; runs the plain twin for CPU tensors."""
    if gx.device.type == "cpu":
        return decode_cell_plain(gx, h, c, x, hp, pv, V, whh, bhh, wx, whs, wg, ws, wh)
    if gx.device.type != "cuda":
        raise ValueError(f"decode_cell runs on cuda or cpu, not {gx.device}")
    from adaptive_tpu_torch.ops.cuda import build

    B, H = h.shape
    E2 = x.shape[1]
    K, D = pv.shape[1], pv.shape[2]
    dt = h.dtype
    if dt not in _DTYPE_CODE:
        raise ValueError(f"decode_cell takes float32 or bfloat16, not {dt}")
    if H % 2:
        raise ValueError(f"decode_cell needs an even hidden size, got {H}")
    for name, t, shape in (
        ("gx", gx, (B, 4 * H)), ("c", c, (B, H)), ("x", x, (B, E2)),
        ("h_prev", hp, (B, H)), ("pv", pv, (B, K, D)), ("V", V, (B, K, H)),
        ("w_hh", whh, (H, 4 * H)), ("b_hh", bhh, (4 * H,)), ("w_x", wx, (E2, H)),
        ("w_hs", whs, (H, H)), ("w_g", wg, (H, D)), ("w_s", ws, (H, D)), ("w_h", wh, (D,)),
    ):
        _check_shape(name, t, shape)
    _check_cuda(("gx",), (gx,), torch.float32, gx.device)
    _check_cuda(
        ("h", "c", "x", "h_prev", "pv", "V", "w_hh", "b_hh", "w_x", "w_hs", "w_g", "w_s", "w_h"),
        (h, c, x, hp, pv, V, whh, bhh, wx, whs, wg, ws, wh), dt, gx.device,
    )
    h_out, c_out, chat = (torch.empty((B, H), dtype=dt, device=gx.device) for _ in range(3))
    alpha = torch.empty((B, K), dtype=torch.float32, device=gx.device)
    beta = torch.empty((B, 1), dtype=torch.float32, device=gx.device)
    lib = build.load()
    with torch.cuda.device(gx.device):  # the launch goes to the current device
        err = lib.adaptive_cell_launch(
            _DTYPE_CODE[dt], *map(_ptr, (gx, h, c, x, hp, pv, V, whh, bhh, wx, whs, wg, ws, wh,
                                         h_out, c_out, chat, alpha, beta)),
            B, H, E2, K, D, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    _raise_on(err, "decode_cell")
    decode_cell.launches += 1
    return h_out, c_out, chat, alpha, beta


decode_cell.launches = 0


def cell_operands(lstm: Dict, atten: Dict, sentinel: Dict) -> Tuple[torch.Tensor, ...]:
    """(w_hh, b_hh, w_x, w_hs, w_g, w_s, w_h) for decode_cell from the
    JAX-layout parameter dicts."""
    return (lstm["w_hh"], lstm["b_hh"], sentinel["affine_x"]["kernel"],
            sentinel["affine_h"]["kernel"], atten["affine_g"]["kernel"],
            atten["affine_s"]["kernel"], atten["affine_h"]["kernel"].reshape(-1))


def adaptive_decode_cell_fused(lstm: Dict, atten: Dict, sentinel: Dict, x, h_in,
                               c_in, h_prev, V, pv):
    """LSTM + sentinel + adaptive attention for one token (beam_w == 1).

    x [B,2E], h_in/c_in/h_prev [B,H], V [B,K,H], pv [B,K,D]. Returns
    (h [B,H], c [B,H], c_hat [B,H], alpha [B,K] fp32, beta [B,1] fp32). The
    input projection stays a full-batch matmul outside the kernel, computed
    in the compute dtype and then cast to fp32, as the JAX package does."""
    gx = (x @ lstm["w_ih"] + lstm["b_ih"]).float()
    return decode_cell(gx, h_in, c_in, x, h_prev, pv, V, *cell_operands(lstm, atten, sentinel))


# ------------------------------------------------------------- head argmax
def greedy_head_argmax_plain(head_kernel, head_bias, chat, h, vocab_len: int):
    """Plain twin of the head kernel: (chat + h) rounded to the weight dtype,
    fp32 product and bias, columns >= vocab_len set to -1e30, first max."""
    z = (chat + h).to(head_kernel.dtype).float()
    logits = z @ head_kernel.float() + head_bias.float()
    col = torch.arange(logits.shape[1], device=logits.device)
    logits = torch.where(col < vocab_len, logits, torch.full_like(logits, NEG))
    return torch.argmax(logits, dim=-1).to(torch.int32)


def greedy_head_argmax(head_kernel, head_bias, chat, h, vocab_len: int):
    """argmax((chat + h) @ W + b) over the real vocab -> [B] int32.
    head_kernel [H, Vp] / head_bias [Vp] come padded from prepare_greedy_head
    (Vp a multiple of HEAD_TILE). Launches the CUDA kernel for CUDA tensors;
    runs the plain twin for CPU tensors."""
    if chat.device.type == "cpu":
        return greedy_head_argmax_plain(head_kernel, head_bias, chat, h, vocab_len)
    if chat.device.type != "cuda":
        raise ValueError(f"greedy_head_argmax runs on cuda or cpu, not {chat.device}")
    from adaptive_tpu_torch.ops.cuda import build

    B, H = chat.shape
    Vp = head_kernel.shape[1]
    dt = head_kernel.dtype
    if dt not in _DTYPE_CODE:
        raise ValueError(f"greedy_head_argmax takes float32 or bfloat16, not {dt}")
    if Vp % HEAD_TILE:
        raise ValueError(f"padded vocab {Vp} must be a multiple of {HEAD_TILE}")
    if not 0 < vocab_len <= Vp:
        raise ValueError(f"vocab_len {vocab_len} outside (0, {Vp}]")
    _check_shape("h", h, (B, H))
    _check_shape("head_kernel", head_kernel, (H, Vp))
    _check_shape("head_bias", head_bias, (Vp,))
    _check_cuda(("chat", "h", "head_kernel", "head_bias"),
                (chat, h, head_kernel, head_bias), dt, chat.device)
    ntiles = Vp // HEAD_TILE
    part_v = torch.empty((B, ntiles), dtype=torch.float32, device=chat.device)
    part_i = torch.empty((B, ntiles), dtype=torch.int32, device=chat.device)
    out = torch.empty((B,), dtype=torch.int32, device=chat.device)
    lib = build.load()
    with torch.cuda.device(chat.device):  # the launch goes to the current device
        err = lib.head_argmax_launch(
            _DTYPE_CODE[dt], *map(_ptr, (chat, h, head_kernel, head_bias, part_v, part_i, out)),
            B, H, Vp, vocab_len, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        )
    _raise_on(err, "greedy_head_argmax")
    greedy_head_argmax.launches += 1
    return out


greedy_head_argmax.launches = 0

KERNEL_WRAPPERS = (decode_cell, greedy_head_argmax)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
