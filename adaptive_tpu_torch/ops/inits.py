"""Weight initializers with PyTorch-equivalent semantics, drawn from an
explicit ``torch.Generator`` (counterpart of adaptive_tpu/ops/inits.py).

Shapes follow the JAX package's convention: a linear kernel is (fan_in,
fan_out), applied as ``x @ W``. The port's modules store the transpose
(torch's [out, in]) and transpose what these functions return. Conv kernels
are drawn in models/resnet.py::init_resnet_.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

# torch.nn.init.calculate_gain
GAINS = {
    "linear": 1.0,
    "sigmoid": 1.0,
    "tanh": 5.0 / 3.0,
    "relu": math.sqrt(2.0),
}


def _uniform(gen, shape, bound, device):
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return out.uniform_(-bound, bound, generator=gen)


def _normal(gen, shape, std, device):
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return out.normal_(0.0, std, generator=gen)


def xavier_uniform(gen, shape, nonlinearity="linear", device="cpu"):
    fan_in, fan_out = shape
    a = GAINS[nonlinearity] * math.sqrt(6.0 / (fan_in + fan_out))
    return _uniform(gen, shape, a, device)


def xavier_normal(gen, shape, nonlinearity="linear", device="cpu"):
    fan_in, fan_out = shape
    std = GAINS[nonlinearity] * math.sqrt(2.0 / (fan_in + fan_out))
    return _normal(gen, shape, std, device)


def kaiming_uniform(gen, shape, nonlinearity="relu", device="cpu"):
    fan_in = shape[0]
    bound = math.sqrt(3.0) * GAINS[nonlinearity] / math.sqrt(fan_in)
    return _uniform(gen, shape, bound, device)


def kaiming_normal(gen, shape, nonlinearity="relu", device="cpu"):
    fan_in = shape[0]
    return _normal(gen, shape, GAINS[nonlinearity] / math.sqrt(fan_in), device)


SCHEMES = {
    "xavier_uniform": xavier_uniform,
    "xavier_normal": xavier_normal,
    "kaiming_uniform": kaiming_uniform,
    "kaiming_normal": kaiming_normal,
}


def orthogonal(gen, shape, device="cpu"):
    """torch.nn.init.orthogonal_ semantics on (rows, cols): QR of a standard
    normal matrix with sign correction; semi-orthogonal when rectangular."""
    rows, cols = shape
    a = _normal(gen, (max(rows, cols), min(rows, cols)), 1.0, device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return q.T.contiguous() if rows < cols else q


def lstm_init(gen, input_size: int, hidden_size: int, device="cpu") -> Dict[str, torch.Tensor]:
    """LSTM weights in torch's layout (w_ih [4H,in], w_hh [4H,H], gate order
    i,f,g,o): orthogonal weights, zero biases except 0.5 on each forget slice."""
    w_ih = orthogonal(gen, (4 * hidden_size, input_size), device)
    w_hh = orthogonal(gen, (4 * hidden_size, hidden_size), device)
    b = torch.zeros(4 * hidden_size, device=device)
    b[hidden_size:2 * hidden_size] = 0.5
    return {"w_ih": w_ih, "w_hh": w_hh, "b_ih": b, "b_hh": b.clone()}


def linear_weight(gen, in_dim: int, out_dim: int, init: str, nonlinearity: str,
                  device="cpu") -> torch.Tensor:
    """A linear weight in torch's [out, in] layout, drawn as the (in, out)
    kernel the JAX package draws and transposed."""
    return SCHEMES[init](gen, (in_dim, out_dim), nonlinearity, device).T.contiguous()


def linear(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """y = x @ kernel (+ bias), kernel [in, out]."""
    y = x @ params["kernel"]
    if "bias" in params:
        y = y + params["bias"]
    return y
