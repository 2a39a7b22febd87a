"""Inference path of the encoder: BN folding + compute-dtype weight casting
(counterpart of adaptive_tpu/models/infer.py, quant="none" only).

Eval-mode BatchNorm is an affine map, so it folds into the preceding conv:
kernel' = kernel * scale/sqrt(var+eps) per out-channel, bias' = bias_bn -
mean * scale/sqrt(var+eps). ``prepare_encoder_inference`` does that once per
checkpoint; the per-batch forward then runs conv+bias+relu only. Folded conv
kernels are torch's OIHW, stored channels_last to match the activations.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from adaptive_tpu_torch.models.encoder import AttentiveCNN, encoder_heads, head_params
from adaptive_tpu_torch.models.resnet import RESNET_SPECS, ResNet

INT8_TODO = ("encoder_quant='int8' is not ported yet: ROADMAP.md, queue 1, "
             "item 7 (int8 encoder)")


def cast_floating(tree: Any, dtype) -> Any:
    """Cast every floating tensor of a dict/list tree to dtype."""
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def _fold(conv, bn) -> Dict[str, torch.Tensor]:
    inv = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return {
        "kernel": (conv.weight * inv[:, None, None, None]).contiguous(
            memory_format=torch.channels_last),
        "bias": bn.bias - bn.running_mean * inv,
    }


@torch.no_grad()
def fold_resnet(net: ResNet) -> Dict[str, Any]:
    """Fold every BN of the ResNet into its conv: {"conv1": {kernel, bias},
    "layer1": [{"conv1", "conv2"[, "conv3"][, "downsample"]}, ...], ...}."""
    out: Dict[str, Any] = {"conv1": _fold(net[0], net[1])}
    n_convs = 3 if RESNET_SPECS[net.arch][0] == "bottleneck" else 2
    for li, layer in enumerate(net.layers()):
        blocks = []
        for blk in layer:
            fp = {f"conv{ci}": _fold(getattr(blk, f"conv{ci}"), getattr(blk, f"bn{ci}"))
                  for ci in range(1, n_convs + 1)}
            if blk.downsample is not None:
                fp["downsample"] = _fold(blk.downsample[0], blk.downsample[1])
            blocks.append(fp)
        out[f"layer{li + 1}"] = blocks
    return out


def _conv(x, p, stride=1):
    pad = (p["kernel"].shape[-1] - 1) // 2
    return F.conv2d(x, p["kernel"].to(x.dtype), p["bias"].to(x.dtype), stride, pad)


def resnet_apply_folded(folded: Dict, x: torch.Tensor, arch: str) -> torch.Tensor:
    """BN-free forward, NHWC in and out; equals the eval-mode ResNet."""
    block_type, stages = RESNET_SPECS[arch]
    y = x.permute(0, 3, 1, 2)
    y = F.max_pool2d(F.relu(_conv(y, folded["conv1"], 2)), 3, 2, 1)
    for li, n_blocks in enumerate(stages):
        for bi in range(n_blocks):
            p = folded[f"layer{li + 1}"][bi]
            stride = 2 if (li > 0 and bi == 0) else 1
            if block_type == "bottleneck":
                z = F.relu(_conv(y, p["conv1"]))
                z = F.relu(_conv(z, p["conv2"], stride))
                z = _conv(z, p["conv3"])
            else:
                z = F.relu(_conv(y, p["conv1"], stride))
                z = _conv(z, p["conv2"])
            sc = _conv(y, p["downsample"], stride) if "downsample" in p else y
            y = F.relu(z + sc)
    return y.permute(0, 2, 3, 1)


def prepare_encoder_inference(enc: AttentiveCNN, dtype, quant: str = "none") -> Dict:
    """Once per checkpoint: BN-folded convs and affine heads, cast to dtype."""
    if quant == "int8":
        raise NotImplementedError(INT8_TODO)
    prepared = {"resnet": cast_floating(fold_resnet(enc.resnet_conv), dtype)}
    prepared.update(cast_floating(head_params(enc), dtype))
    return prepared


@torch.no_grad()
def encoder_apply_inference(
    enc: Optional[AttentiveCNN], images: torch.Tensor, arch: str, dtype,
    quant: str = "none", prepared: Optional[Dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Preprocessed float NHWC images -> (V, v_g, h0, c0) in dtype. prepared:
    the tree from prepare_encoder_inference (else it is built from enc)."""
    if quant == "int8":
        raise NotImplementedError(INT8_TODO)
    if prepared is None:
        prepared = prepare_encoder_inference(enc, dtype, quant)
    A = resnet_apply_folded(prepared["resnet"], images.to(dtype), arch)
    B, Hf, Wf, C = A.shape
    A_flat = A.reshape(B, Hf * Wf, C)  # slot = h*W + w
    a_g = A_flat.float().mean(dim=1).to(dtype)
    return encoder_heads(prepared, A_flat, a_g)
