"""Spatial, adaptive (visual-sentinel) and recurrent attention math, op by
op (counterpart of adaptive_tpu/ops/attention.py).

V [B, K, H] spatial features (K slots, slot = h*W + w), h [B, T, H] decoder
hiddens, s [B, T, H] sentinel; D is the attention projection dim. Kernels are
the JAX layout (``{"kernel": [in, out]}``, applied as ``x @ W``). The fused
decode cell in ops/fused_step.py computes the adaptive variant's step in one
kernel; the other two run op by op on every path, as in the JAX package.
``drop``: train-time dropout (ops/dropout.py) before each affine, where the
reference's Dropout modules sit; None at eval.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from adaptive_tpu_torch.ops.dropout import Drop, maybe_drop as _d
from adaptive_tpu_torch.ops.lstm import lstm_scan


def precompute_slots(params, V: torch.Tensor) -> torch.Tensor:
    """pv = V @ Wv [B, K, D], loop-invariant across decode steps."""
    return V @ params["affine_v"]["kernel"]


def attention_logits(params, V: torch.Tensor, h: torch.Tensor,
                     pv: Optional[torch.Tensor] = None, drop: Drop = None) -> torch.Tensor:
    """z [B, T, K]: z[b,t,i] = sum_j tanh(pv[b,i,j] + (h @ Wg)[b,t,j]) * wh[j].
    Active dropout overrides pv (the hoisted V projection has no mask)."""
    if drop is not None:
        pv = drop(V) @ params["affine_v"]["kernel"]
    elif pv is None:
        pv = precompute_slots(params, V)
    ph = _d(drop, h) @ params["affine_g"]["kernel"]  # [B, T, D]
    content = torch.tanh(pv[:, None, :, :] + ph[:, :, None, :])  # [B, T, K, D]
    return (_d(drop, content) @ params["affine_h"]["kernel"]).squeeze(-1)


def spatial_attention(params, V: torch.Tensor, h: torch.Tensor,
                      pv: Optional[torch.Tensor] = None,
                      drop: Drop = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The baseline's attention (baseline_attention.py:78-96): (c [B,T,H],
    alpha [B,T,K]), alpha the K-way softmax."""
    alpha = torch.softmax(attention_logits(params, V, h, pv, drop), dim=-1)
    return alpha @ V, alpha  # raw V: the bmm has no dropout


def sentinel_gate(params, x: torch.Tensor, h_prev: torch.Tensor,
                  c: torch.Tensor, drop: Drop = None) -> torch.Tensor:
    """s_t = sigmoid(x_t Wx + h_{t-1} Wh) * tanh(c_t). x [B,T,2E], h_prev/c [B,T,H]."""
    g = torch.sigmoid(
        _d(drop, x) @ params["affine_x"]["kernel"]
        + _d(drop, h_prev) @ params["affine_h"]["kernel"]
    )
    return g * torch.tanh(c)


def adaptive_attention(
    params, V: torch.Tensor, h: torch.Tensor, s: torch.Tensor,
    pv: Optional[torch.Tensor] = None, drop: Drop = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(c_hat [B,T,H], alpha [B,T,K], beta [B,T,1]): alpha is the K-way
    spatial softmax; beta the sentinel's share of the (K+1)-way softmax."""
    z = attention_logits(params, V, h, pv, drop)
    alpha = torch.softmax(z, dim=-1)
    c = alpha @ V  # raw V: the bmm has no dropout
    content_s = torch.tanh(
        _d(drop, s) @ params["affine_s"]["kernel"]
        + _d(drop, h) @ params["affine_g"]["kernel"]
    )
    z_s = _d(drop, content_s) @ params["affine_h"]["kernel"]  # [B, T, 1]
    beta = torch.softmax(torch.cat([z, z_s], dim=-1), dim=-1)[..., -1:]
    c_hat = beta * s + (1.0 - beta) * c
    return c_hat, alpha, beta


def recurrent_attention(params, V: torch.Tensor, h: torch.Tensor, bidirectional: bool = True,
                        pv: Optional[torch.Tensor] = None,
                        drop: Drop = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """rnn_attention's attention (rnn_attention.py:31-67): (F_T [B,T,Hr'],
    alpha [B,T,K]). Sigmoid gates weight the slots, and an LSTM (state
    width hr, the lstm_fwd kernels') runs over the K weighted slots of each
    (b, t) from a zero state in V's dtype. Bidirectional: a second LSTM
    (lstm_bwd) over the reversed slots, and F_T = (h_T backward, h_T
    forward), the backward direction first as the reference concatenates
    them (rnn_attention.py:59-60); else F_T is the forward h_T. Dropout
    sits in the logits only."""
    B, K, H = V.shape
    T = h.shape[1]
    alpha = torch.sigmoid(attention_logits(params, V, h, pv, drop))
    flat = (alpha[..., None] * V[:, None]).reshape(B * T, K, H)
    zero = V.new_zeros((B * T, params["lstm_fwd"]["w_hh"].shape[0]))
    _, _, (f, _) = lstm_scan(params["lstm_fwd"], flat, (zero, zero))
    if bidirectional:
        _, _, (f_bwd, _) = lstm_scan(params["lstm_bwd"], flat.flip(1), (zero, zero))
        f = torch.cat([f_bwd, f], dim=-1)
    return f.reshape(B, T, -1), alpha
