"""The prefill of a Mamba-2 layer in plain PyTorch (models/hybrid_lm.py):
the causal depthwise conv over a sequence and the chunked scan of the
state-space model in its matrix form (SSD, "state space duality", Dao and
Gu, arXiv:2405.21060, section 6). The decode step is kernel 8
(ops/ssm_step.py).

A caption's 49 image tokens fit one chunk of granite-4.0-h-micro's 256, so
the scan is a handful of batched products; a longer sequence walks its
chunks in order and carries the state between them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xbc [B, L, C] -> (silu(causal depthwise conv1d(xbc) + b) [B, L, C],
    the conv state [B, K - 1, C]: the last K - 1 raw inputs, zeros before
    the first). w [C, K] (tap K - 1 on the newest input), b [C]."""
    K = w.shape[1]
    pad = F.pad(xbc.transpose(1, 2), (K - 1, 0))  # [B, C, L + K - 1]
    out = F.conv1d(pad, w[:, None, :].to(xbc.dtype), b.to(xbc.dtype), groups=w.shape[0])
    state = pad[:, :, pad.shape[-1] - (K - 1):].transpose(1, 2).contiguous()
    return F.silu(out).transpose(1, 2), state


def ssd_prefill(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, D: torch.Tensor, chunk: int,
                state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan of a sequence: x [B, L, H, P], dt [B, L, H] (after the
    softplus), A and D [H], Bm and Cm [B, L, G, N] (G groups, each shared by
    H / G heads); state [B, H, P, N] at the start (zeros where None).
    Returns (y [B, L, H, P] in fp32, the final state [B, H, P, N] in x's dtype)
    of the recurrence

        S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T,   y_t = S_t C_t + D x_t

    computed a chunk at a time: within a chunk y_i = sum_{j<=i} (C_i . B_j)
    exp(a_i - a_j) dt_j x_j + exp(a_i) S_0 C_i, with a the running sum of
    dt A, and the state leaves it as exp(a_last) S_0 + sum_j exp(a_last -
    a_j) dt_j x_j B_j^T. The decays are fp32; the products take their
    operands in x's dtype (bf16 on the card's tensor cores) and sum in
    fp32."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    dt = dt.float()
    ys = []
    for s in range(0, L, chunk):
        span = slice(s, s + chunk)
        xc, dtc, Bc, Cc = x[:, span], dt[:, span], Bm[:, span], Cm[:, span]
        n = xc.shape[1]
        a = torch.cumsum(dtc * A, dim=1).transpose(1, 2).reshape(Bsz, G, rep, n)  # [B, G, r, n]
        causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
        decay = torch.exp((a[..., :, None] - a[..., None, :]).masked_fill_(~causal, float("-inf")))
        cb = torch.einsum("bign,bjgn->bgij", Cc, Bc)  # [B, G, n, n]
        w = decay.mul_(cb[:, :, None].float()).mul_(
            dtc.transpose(1, 2).reshape(Bsz, G, rep, 1, n)).to(x.dtype)  # [B, G, r, i, j]
        y = torch.einsum("bhij,bjhp->bihp", w.reshape(Bsz, H, n, n), xc).float()
        xw = xc * (torch.exp(a[..., -1:] - a) * dtc.transpose(1, 2).reshape(Bsz, G, rep, n)
                   ).reshape(Bsz, H, n).transpose(1, 2)[..., None].to(x.dtype)
        inc = torch.einsum("bjgrp,bjgn->bgrpn", xw.reshape(Bsz, n, G, rep, P), Bc)
        inc = inc.reshape(Bsz, H, P, N)
        if state is not None:  # carried in fp32
            state = state.float()
            sg = state.reshape(Bsz, G, rep, P, N)
            y = y + (torch.einsum("bign,bgrpn->bigrp", Cc.float(), sg).reshape(Bsz, n, H, P)
                     * torch.exp(a).reshape(Bsz, H, n).transpose(1, 2)[..., None])
            inc = inc + state * torch.exp(a[..., -1]).reshape(Bsz, H)[..., None, None]
        state = inc
        ys.append(torch.addcmul(y, xc, D[:, None]))
    return (ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)), state.to(x.dtype)
