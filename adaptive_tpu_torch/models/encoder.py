"""Attentive CNN encoder: ResNet feature map -> (V, v_g, h0, c0)
(counterpart of adaptive_tpu/models/encoder.py).

``AttentiveCNN`` carries the reference's module names (resnet_conv,
affine_a/b/h0/c0), so its state_dict keys are the reference checkpoint's
``encoder.*`` keys. ``encoder_heads`` takes the affine heads in the JAX
layout ({"kernel": [in, out], "bias": [out]}), as ``head_params`` returns
them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from adaptive_tpu_torch.models.resnet import ResNet, feature_channels, init_resnet_
from adaptive_tpu_torch.ops import inits

HEADS = ("affine_a", "affine_b", "affine_h0", "affine_c0")
# (init scheme, nonlinearity) of each head (baseline_attention.py:29,34)
HEAD_INITS = {
    "affine_a": ("kaiming_uniform", "relu"),
    "affine_b": ("kaiming_uniform", "relu"),
    "affine_h0": ("xavier_uniform", "tanh"),
    "affine_c0": ("xavier_uniform", "tanh"),
}


class AttentiveCNN(nn.Module):
    def __init__(self, embed_size: int, hidden_size: int, arch: str):
        super().__init__()
        self.resnet_conv = ResNet(arch)
        C = feature_channels(arch)
        self.affine_a = nn.Linear(C, hidden_size)
        self.affine_b = nn.Linear(C, embed_size)
        self.affine_h0 = nn.Linear(C, hidden_size)
        self.affine_c0 = nn.Linear(C, hidden_size)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        init_resnet_(self.resnet_conv, gen)
        for name in HEADS:
            lin = getattr(self, name)
            scheme, nl = HEAD_INITS[name]
            lin.weight.copy_(inits.linear_weight(
                gen, lin.in_features, lin.out_features, scheme, nl, lin.weight.device))
            lin.bias.zero_()


def head_params(enc: AttentiveCNN) -> Dict[str, Dict[str, torch.Tensor]]:
    """The affine heads in the JAX layout: kernel = weight.T (contiguous)."""
    out = {}
    for name in HEADS:
        lin = getattr(enc, name)
        out[name] = {"kernel": lin.weight.detach().T.contiguous(),
                     "bias": lin.bias.detach()}
    return out


def encoder_heads(
    params: Dict, A_flat: torch.Tensor, a_g: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(V [B,K,H], v_g [B,E], h0 [B,H], c0 [B,H]) from the trunk features
    A_flat [B,K,C] (slot = h*W + w) and a_g [B,C]."""
    V = torch.relu(inits.linear(params["affine_a"], A_flat))
    v_g = torch.relu(inits.linear(params["affine_b"], a_g))
    h0 = torch.tanh(inits.linear(params["affine_h0"], a_g))
    c0 = torch.tanh(inits.linear(params["affine_c0"], a_g))
    return V, v_g, h0, c0
