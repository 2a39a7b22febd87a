"""LSTM cell with torch's math: gate order i,f,g,o and two bias vectors,
and its loop over time (counterpart of adaptive_tpu/ops/lstm.py). Parameters use the JAX layout:
w_ih [in, 4H], w_hh [H, 4H], b_ih/b_hh [4H], applied as ``x @ W``."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

LSTMState = Tuple[torch.Tensor, torch.Tensor]  # (h, c), each [B, H]


def _gates_step(gates_x: torch.Tensor, params: Dict[str, torch.Tensor],
                state: LSTMState) -> Tuple[torch.Tensor, LSTMState]:
    """Cell math given gates_x = x @ w_ih + b_ih: c' = f*c + i*g, h' = o*tanh(c')."""
    h, c = state
    gates = gates_x + h @ params["w_hh"] + params["b_hh"]
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, (h_new, c_new)


def lstm_cell(params: Dict[str, torch.Tensor], x: torch.Tensor,
              state: LSTMState) -> Tuple[torch.Tensor, LSTMState]:
    """One step. x [B, I]; returns (h', (h', c'))."""
    return _gates_step(x @ params["w_ih"] + params["b_ih"], params, state)


def lstm_scan(params: Dict[str, torch.Tensor], xs: torch.Tensor,
              state: LSTMState) -> Tuple[torch.Tensor, torch.Tensor, LSTMState]:
    """Run the cell over time. xs [B, T, I] -> (hiddens [B,T,H], cells
    [B,T,H], final state). The time-invariant x @ w_ih + b_ih is one matmul
    over all T steps; only the h @ w_hh recurrence loops. The per-step cells
    are returned because the sentinel reads them (nn.LSTM returns only the
    last one)."""
    gx = xs @ params["w_ih"] + params["b_ih"]  # [B, T, 4H]
    hs, cs = [], []
    for t in range(xs.shape[1]):
        h, state = _gates_step(gx[:, t], params, state)
        hs.append(h)
        cs.append(state[1])
    return torch.stack(hs, 1), torch.stack(cs, 1), state
