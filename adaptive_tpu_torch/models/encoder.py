"""Attentive CNN encoder: ResNet feature map -> (V, v_g, h0, c0)
(counterpart of adaptive_tpu/models/encoder.py).

``AttentiveCNN`` carries the reference's module names (resnet_conv,
affine_a/b/h0/c0), so its state_dict keys are the reference checkpoint's
``encoder.*`` keys. ``encoder_heads`` takes the affine heads in the JAX
layout ({"kernel": [in, out], "bias": [out]}), as ``head_params`` returns
them. ``encoder_apply`` is the train (and plain eval) forward on the
module's own weights; the decode path runs models/infer.py's folded one.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from adaptive_tpu_torch.models.resnet import ResNet, feature_channels, init_resnet_
from adaptive_tpu_torch.ops import inits
from adaptive_tpu_torch.ops.dropout import Drop, maybe_drop as _d

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


def head_params(enc: AttentiveCNN, detach: bool = True) -> Dict[str, Dict[str, torch.Tensor]]:
    """The affine heads in the JAX layout, kernel = weight.T: contiguous
    copies outside autograd (the decode path), or with detach=False views
    that carry gradients to the weights (the train path)."""
    out = {}
    for name in HEADS:
        lin = getattr(enc, name)
        w, b = (lin.weight.detach(), lin.bias.detach()) if detach else (lin.weight, lin.bias)
        out[name] = {"kernel": w.T.contiguous() if detach else w.T, "bias": b}
    return out


def _linear(params, x):
    """inits.linear with JAX's type promotion: bf16 features against fp32
    kernels compute in fp32."""
    return inits.linear(params, x.to(torch.promote_types(x.dtype, params["kernel"].dtype)))


def encoder_heads(
    params: Dict, A_flat: torch.Tensor, a_g: torch.Tensor, drop: Drop = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(V [B,K,H], v_g [B,E], h0 [B,H], c0 [B,H]) from the trunk features
    A_flat [B,K,C] (slot = h*W + w) and a_g [B,C]. drop: train-time dropout
    before each affine (baseline_attention.py:51-58)."""
    V = torch.relu(_linear(params["affine_a"], _d(drop, A_flat)))
    v_g = torch.relu(_linear(params["affine_b"], _d(drop, a_g)))
    h0 = torch.tanh(_linear(params["affine_h0"], _d(drop, a_g)))
    c0 = torch.tanh(_linear(params["affine_c0"], _d(drop, a_g)))
    return V, v_g, h0, c0


def encoder_features(enc: AttentiveCNN, images: torch.Tensor, train: bool = False,
                     grad_from: int = 0, update_stats: bool = True,
                     bn_group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """ResNet trunk only: images NHWC float -> (A_flat [B,K,C], a_g [B,C]),
    in the images' dtype. Train mode updates the BN running statistics in
    place unless update_stats is False. grad_from, bn_group: ResNet.forward's
    frozen prefix and BN process group."""
    A = enc.resnet_conv(images, train, grad_from, update_stats, bn_group)
    B, Hf, Wf, C = A.shape
    A_flat = A.reshape(B, Hf * Wf, C)  # slot = h*W + w
    return A_flat, A_flat.mean(dim=1)  # AvgPool2d(7) == global mean


def encoder_apply(enc: AttentiveCNN, images: torch.Tensor, train: bool = False,
                  drop: Drop = None, grad_from: int = 0, update_stats: bool = True,
                  bn_group=None):
    """images NHWC float -> (V, v_g, h0, c0) on the module's weights."""
    A_flat, a_g = encoder_features(enc, images, train, grad_from, update_stats, bn_group)
    return encoder_heads(head_params(enc, detach=False), A_flat, a_g, drop)
