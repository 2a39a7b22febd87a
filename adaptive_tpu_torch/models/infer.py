"""Inference path of the encoder: BN folding, compute-dtype weight casting
and the int8 encoder (counterpart of adaptive_tpu/models/infer.py).

Eval-mode BatchNorm is an affine map, so it folds into the preceding conv:
kernel' = kernel * scale/sqrt(var+eps) per out-channel, bias' = bias_bn -
mean * scale/sqrt(var+eps). ``prepare_encoder_inference`` does that once per
checkpoint; the per-batch forward then runs conv+bias+relu only: each conv
without its bias, then one pass of ops/conv_epilogue.py::folded_epilogue
adds the bias (and the residual) and applies the relu; a stride-1 1x1 conv
of a bf16 activation runs as one GEMM with that epilogue
(ops/conv1x1.py::conv1x1_epilogue). Folded conv kernels are torch's OIHW,
stored channels_last to match the activations.

quant="int8" is symmetric post-training quantisation: per-output-channel s8
weights, s8 activations with calibrated static scales (``calibrate_model``;
per tensor, or per input channel folded into the weights), int32
accumulation and an fp32 rescale + bias between convs. With static scales
the inter-block activation lives as s8 + scale (the int8 residual carry,
``_resnet_int8_carry``); uncalibrated, each conv quantises its input with a
dynamic per-tensor scale. The int8 convolutions are ``torch._int_mm`` over
im2col rows of the NHWC activations (ops/int8.py); ``fused_layers`` and
``fused_tails`` route identity blocks through the fused CUDA kernels of
ops/fused_block.py and ops/fused_tail.py.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from adaptive_tpu_torch.models.encoder import AttentiveCNN, encoder_heads, head_params
from adaptive_tpu_torch.models.resnet import RESNET_SPECS, ResNet
from adaptive_tpu_torch.ops import conv1x1 as CX
from adaptive_tpu_torch.ops import conv_epilogue as CE
from adaptive_tpu_torch.ops import fused_block as FB
from adaptive_tpu_torch.ops import fused_tail as FT
from adaptive_tpu_torch.ops.int8 import f32, im2col, int_mm, requant, true_div, wmat


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
    # in float64, rounded once to the weights' type: the same bits on the
    # card and the CPU (the card's float32 rsqrt and sqrt are not correctly
    # rounded, and an ulp of a folded kernel can move its int8 rounding)
    d = torch.float64
    inv = bn.weight.to(d) / torch.sqrt((bn.running_var + bn.eps).to(d))
    dt = conv.weight.dtype
    return {
        "kernel": (conv.weight.to(d) * inv[:, None, None, None]).to(dt).contiguous(
            memory_format=torch.channels_last),
        "bias": (bn.bias.to(d) - bn.running_mean.to(d) * inv).to(dt),
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


def _float_conv(x, k, bias, stride, pad):
    """Float conv of NHWC x with a folded OIHW kernel k and bias (or None).
    pad: symmetric ((k, k), (k, k)), or None for SAME (the 7x7 stem's (3, 3)
    and every other conv's (k - 1) / 2 alike). The NCHW view of an NHWC
    tensor is channels_last, as the folded kernels are stored, and so is the
    conv's output: its NHWC view is contiguous."""
    padding = (k.shape[-1] - 1) // 2 if pad is None else pad[0][0]
    y = F.conv2d(x.permute(0, 3, 1, 2), k.to(x.dtype), bias, stride, padding)
    return y.permute(0, 2, 3, 1)


def _plain_conv(name, x, p, stride, pad):
    """A folded conv with its bias: the pre-activation _folded_forward's
    conv_fn returns."""
    return _float_conv(x, p["kernel"], p["bias"].to(x.dtype), stride, pad)


def _bias_free_conv(name, x, p, stride, pad):
    """A folded conv without its bias, which _fused_epilogue adds."""
    return _float_conv(x, p["kernel"], None, stride, pad)


def _max_pool(y):
    """3x3/s2 max-pool of NHWC y, padding 1 (padded cells never win)."""
    return F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def _fused_epilogue(z, p, residual=None, residual_p=None):
    """The epilogue of _bias_free_conv's outputs: the conv's bias (and the
    downsample's, on its raw output) added, the residual and the relu, in one
    pass written into z (conv_epilogue.folded_epilogue)."""
    rb = None if residual_p is None else residual_p["bias"].to(z.dtype)
    return CE.folded_epilogue(z, p["bias"].to(z.dtype), residual, rb)


def _fused_conv(name, x, p, stride, pad, residual=None, residual_p=None):
    """The float encoder's conv and epilogue: a stride-1 1x1 conv of a bf16
    activation as one GEMM with the epilogue in it (conv1x1.conv1x1_epilogue),
    any other conv as _bias_free_conv followed by _fused_epilogue."""
    k = p["kernel"]
    if stride == 1 and tuple(k.shape[-2:]) == (1, 1) and x.dtype == torch.bfloat16:
        rb = None if residual_p is None else residual_p["bias"].to(x.dtype)
        return CX.conv1x1_epilogue(x, k.to(x.dtype), p["bias"].to(x.dtype), residual, rb)
    return _fused_epilogue(_bias_free_conv(name, x, p, stride, pad), p, residual, residual_p)


def _folded_forward(folded: Dict, x: torch.Tensor, arch: str, conv_fn,
                    conv_act=None) -> torch.Tensor:
    """Single NHWC traversal shared by the float, dynamic-int8 and
    calibration forwards. conv_fn(name, x, params, stride, pad) -> the conv's
    output; names follow torchvision ('conv1', 'layerL.B.convN',
    'layerL.B.downsample'). conv_act(name, x, params, stride, pad,
    residual=None, residual_p=None) -> the activation of a conv with params:
    a block's last conv takes the block input as its residual, or the
    downsample's output (conv_fn's, run before that conv) with its params as
    residual_p. The default is relu(z) or relu(z + residual), conv_fn's
    output z taken as the biased pre-activation."""
    if conv_act is None:
        def conv_act(name, xx, p, stride, pad, residual=None, residual_p=None):
            z = conv_fn(name, xx, p, stride, pad)
            return F.relu(z if residual is None else z + residual)

    block_type, stages = RESNET_SPECS[arch]
    y = _max_pool(conv_act("conv1", x, folded["conv1"], 2, ((3, 3), (3, 3))))
    for li, n_blocks in enumerate(stages):
        for bi in range(n_blocks):
            p = folded[f"layer{li + 1}"][bi]
            nm = f"layer{li + 1}.{bi}"
            stride = 2 if (li > 0 and bi == 0) else 1
            if block_type == "bottleneck":
                z = conv_act(f"{nm}.conv1", y, p["conv1"], 1, None)
                z = conv_act(f"{nm}.conv2", z, p["conv2"], stride, None)
                last = "conv3"
            else:
                z = conv_act(f"{nm}.conv1", y, p["conv1"], stride, None)
                last = "conv2"
            r, rp = y, None
            if "downsample" in p:
                rp = p["downsample"]
                r = conv_fn(f"{nm}.downsample", y, rp, stride, None)
            y = conv_act(f"{nm}.{last}", z, p[last], 1, None, r, rp)
    return y


def resnet_apply_folded(folded: Dict, x: torch.Tensor, arch: str) -> torch.Tensor:
    """BN-free forward, NHWC in and out; equals the eval-mode ResNet. Each
    conv runs without its bias, and one pass of the fused epilogue follows
    it (1 + 3 x 50 passes in ResNet-152); in bf16 the stride-1 1x1 convs
    (every conv1 and conv3 of a bottleneck, 100 in ResNet-152) take their
    epilogue inside one GEMM instead, and the stem and every conv2 keep the
    pass (51)."""
    return _folded_forward(folded, x, arch, _bias_free_conv, _fused_conv)


# ------------------------------------------------------------- int8 path
# Symmetric PTQ: per-output-channel s8 weights, s8 activations. Every integer
# product accumulates in int32 and is exact, on any device and in any order;
# the fp32 epilogues (acc * scale + bias, relu, y / s, round half to even,
# clamp) are separate IEEE operations, so the CPU and the card agree to the
# bit and the JAX package's XLA forward up to its own FMA contraction.

_requant = requant  # models/infer.py::_requant of the JAX package: fp32 -> s8


def _quant_w(kernel: torch.Tensor):
    """Per-output-channel symmetric int8 of an OIHW kernel: (w_i8 OIHW,
    scale [O]). The max runs over dims 1-3 (JAX's HWIO axes 0-2)."""
    amax = kernel.abs().amax(dim=(1, 2, 3))
    scale = true_div(torch.clamp_min(amax, 1e-8), 127.0)
    w = torch.clamp(torch.round(kernel / scale[:, None, None, None]), -127, 127)
    return w.to(torch.int8), scale


def _quant_x(x: torch.Tensor, scale=None):
    """Per-tensor symmetric int8: (x_s8, scale); with scale=None the scale
    is computed from the tensor (a full max-abs reduce)."""
    xf = x.float()
    if scale is None:
        scale = true_div(torch.clamp_min(xf.abs().amax(), 1e-8), 127.0)
    return _requant(xf, scale), scale


def _conv_acc(x_s8: torch.Tensor, wq: torch.Tensor, stride: int = 1, pad=None) -> torch.Tensor:
    """int8 conv of NHWC x_s8 with an OIHW s8 kernel -> int32 NHWC: im2col
    rows times the kernel's [kh*kw*I, O] matrix (torch._int_mm). pad =
    ((top, bottom), (left, right)), None for SAME."""
    O, _, kh, kw = wq.shape
    if pad is None:
        pad = (((kh - 1) // 2,) * 2, ((kw - 1) // 2,) * 2)
    B, H, W, _ = x_s8.shape
    (pt, pb), (pl, pr) = pad
    Ho, Wo = (H + pt + pb - kh) // stride + 1, (W + pl + pr - kw) // stride + 1
    acc = int_mm(im2col(x_s8, kh, kw, stride, pad), wmat(wq).t())
    return acc.reshape(B, Ho, Wo, O)


def _conv_i8(x, p, stride=1, out_dtype=torch.bfloat16, x_scale=None, pad=None):
    """The dynamic path's conv: quantise x and the kernel, int8 conv, fp32
    rescale + bias, cast to out_dtype."""
    xq, sx = _quant_x(x, x_scale)
    wq, sw = _quant_w(p["kernel"].float())
    acc = _conv_acc(xq, wq, stride, pad)
    y = acc.float() * (sx * sw) + p["bias"].float()
    return y.to(out_dtype)


def _quant_conv_weight(kernel: torch.Tensor, x_scale):
    """(int8 OIHW weight, fp32 [O] scale for the int32 accumulator).

    x_scale may be a per-input-channel vector [I] (granularity 'channel'):
    sum_c (x_q[c] sx[c]) w[c] == sum_c x_q[c] (w sx)[c], so the activation
    scale folds into the fp32 kernel before weight quantisation. A scalar
    x_scale gives (_quant_w(k)[0], sw * x_scale)."""
    kernel = kernel.float()
    if getattr(x_scale, "ndim", 0) >= 1:
        kernel = kernel * f32(x_scale, kernel).reshape(1, -1, 1, 1)
        x_scale = 1.0
    wq, sw = _quant_w(kernel)
    return wq, sw * f32(x_scale, sw)


def _prepared_conv(cp: Dict, x_scale) -> Dict:
    """A conv dict as {'wq', 'scale', 'bias'}: prepared ones pass through,
    raw {'kernel', 'bias'} ones are quantised here."""
    if "wq" in cp:
        return cp
    wq, sc = _quant_conv_weight(cp["kernel"], x_scale)
    return {"wq": wq, "scale": sc, "bias": cp["bias"].float()}


def _acc_i8(x_s8, p, x_scale, stride=1, pad=None):
    """int8 conv from a folded conv dict: (int32 NHWC accumulator, fp32 [O]
    scale). p carries either a raw fp32 'kernel' (quantised here, every call)
    or a prepared {'wq', 'scale'} pair from prepare_encoder_inference
    (quantised once). A bare kernel tensor is also accepted."""
    if not isinstance(p, dict):
        p = {"kernel": p}
    if "wq" in p:
        wq, sc = p["wq"], p["scale"]
    else:
        wq, sc = _quant_conv_weight(p["kernel"], x_scale)
    return _conv_acc(x_s8, wq, stride, pad), sc


# ------------------------------------------------- space-to-depth stem
# The 7x7/s2 stem reads 3 input channels. Packing 2x2 pixel blocks into
# channels (224,224,3 -> 112,112,12) turns it into a 4x4/s1 conv whose kernel
# holds the 7x7 taps scattered into 4x4x12 (15 zero taps). Output(i, j) =
# sum_{u,v} x[2i+u-3, 2j+v-3] w[u, v]; with u = 2a+r-1 (a in 0..3, r in 0..1)
# the receptive field spans 4 s2d rows/cols with padding (2, 1). Bit-exact on
# the int8 path: the integer products are the same set, and _quant_w's
# per-out-channel max is unchanged by added zeros. On the card the K of its
# product is 4*4*12 = 192 against the 7x7 stem's 147, padded to 152.


def _s2d(x: torch.Tensor) -> torch.Tensor:
    """[B,H,W,C] -> [B,H/2,W/2,4C], channel order (row, col, C) row-major."""
    B, H, W, C = x.shape
    y = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(B, H // 2, W // 2, 4 * C)


def _stem_s2d_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """OIHW [Cout, Cin, 7, 7] -> [Cout, 4*Cin, 4, 4]: w'[o, (r, q, ch), a, b]
    = w[o, ch, 2a+r-1, 2b+q-1] (a zero row/col in front realizes the u = -1
    / v = -1 taps)."""
    Cout, Cin, K, _ = kernel.shape
    assert K == 7, K
    wp = F.pad(kernel, (1, 0, 1, 0)).reshape(Cout, Cin, 4, 2, 4, 2)
    wp = wp.permute(0, 3, 5, 1, 2, 4)  # [o, r, q, ch, a, b]
    return wp.reshape(Cout, 4 * Cin, 4, 4).contiguous(memory_format=torch.channels_last)


def _stem_s2d_conv(p: Dict, s0):
    """(conv dict with the s2d-rewritten 4x4 kernel, matching input scale).
    _s2d packs channels (row, col, C), so a per-channel image scale tiles 4x.
    The one owner of this pairing, for the inline forward and
    prepare_encoder_inference alike."""
    if getattr(s0, "ndim", 0) >= 1:
        s0 = s0.repeat(4) if isinstance(s0, torch.Tensor) else np.tile(np.asarray(s0, np.float32), 4)
    return {**p, "kernel": _stem_s2d_kernel(p["kernel"])}, s0


def _device_scales(scales: Dict, like: torch.Tensor) -> Dict:
    """Per-channel (numpy vector) scales as fp32 tensors on like's device,
    moved in one copy; scalar scales stay Python floats (the fused kernels
    take them by value, and a requant makes them 0-dim tensors on the
    device without a copy)."""
    vec = {k: np.asarray(v, np.float32) for k, v in scales.items() if isinstance(v, np.ndarray)}
    if not vec:
        return scales
    flat = torch.from_numpy(np.concatenate(list(vec.values())))
    if like.device.type == "cuda":
        flat = flat.pin_memory()
    flat = flat.to(like.device, non_blocking=True)
    out, off = dict(scales), 0
    for k, v in vec.items():
        out[k] = flat[off:off + v.size]
        off += v.size
    return out


# ------------------------------------------------- fused int8 kernels
def _fused_identity_block(p: Dict, y_s8: torch.Tensor, s_in: float, s2: float, s3: float,
                          s_out: float) -> torch.Tensor:
    """One identity bottleneck block through the fused kernel
    (ops/fused_block.py): the carry segment's math with z1 and z2 kept on
    chip. Caller guarantees stride 1, no downsample, and a next-block scale
    (not the last block). With a prepared block the weights were quantised
    once; a raw block is quantised here to the same bits (the prepared
    scale sw * s is the fused path's s * sw)."""
    B, H, W, C = y_s8.shape
    c1, c2, c3 = (_prepared_conv(p[f"conv{i}"], s) for i, s in ((1, s_in), (2, s2), (3, s3)))
    out = FB.bottleneck_identity_int8(
        y_s8.reshape(B * H * W, C), H, W, wmat(c1["wq"]), wmat(c2["wq"]), wmat(c3["wq"]),
        c1["scale"], c1["bias"], c2["scale"], c2["bias"], c3["scale"], c3["bias"],
        s2, s3, s_in, s_out,
    )
    return out.reshape(B, H, W, C)


def _block_fusable(p: Dict, stride: int, last: bool, fused_layers, layer_name: str) -> bool:
    """An identity bottleneck block of a layer in fused_layers: stride 1,
    not the last block, no downsample. The JAX package also asks H == W and
    an int8-sublane-aligned image group (TPU tiling rules); the CUDA kernel
    takes any B, H and W."""
    if layer_name not in (fused_layers or ()):
        return False
    return not (stride != 1 or last or "downsample" in p or "conv3" not in p)


def _tail_fusable(p: Dict, stride: int, last: bool, fused_tails, layer_name: str) -> bool:
    """Boundary (i, i+1) is tail-fusable when block i is an identity
    bottleneck of a layer in fused_tails. Block i+1 needs no checks: a
    bottleneck conv1 is always 1x1 stride 1, so the fused computation is
    valid even into a downsample block. The JAX package also asks B*H*W % 32
    == 0 (the s8 sublane tile); the CUDA kernel takes any row count."""
    if layer_name not in (fused_tails or ()):
        return False
    return not (stride != 1 or last or "downsample" in p or "conv3" not in p)


def _fused_tail_pair(p: Dict, next_p: Dict, y_s8_in: torch.Tensor, z2f: torch.Tensor,
                     s3: float, s_in: float, s_out: float, s_next: float):
    """Block i's tail (conv3 + s8 residual + relu + requant) fused with
    block i+1's conv1 (+ relu + requant) in one kernel (ops/fused_tail.py).
    y_s8_in: block i's input carry [B,H,W,C]; z2f: block i's conv2 relu
    output (fp32). Returns (carry_s8 [B,H,W,C], z1_next_s8 [B,H,W,M2])."""
    B, H, W, C = y_s8_in.shape
    N, M = B * H * W, z2f.shape[-1]
    c3 = _prepared_conv(p["conv3"], s3)
    c1 = _prepared_conv(next_p["conv1"], s_out)
    M2 = c1["wq"].shape[0]
    out, z1 = FT.tail_conv1_int8(
        y_s8_in.reshape(N, C), _requant(z2f, s3).reshape(N, M),
        wmat(c3["wq"]), c3["scale"], c3["bias"], wmat(c1["wq"]), c1["scale"], c1["bias"],
        s_in, s_out, s_next,
    )
    return out.reshape(B, H, W, C), z1.reshape(B, H, W, M2)


# ------------------------------------------------- int8 carry forward
def resnet_apply_folded_int8(
    folded: Dict, x: torch.Tensor, arch: str, scales: Optional[Dict] = None,
    fused_layers=(), fused_tails=(), stem_s2d: bool = False,
    bias_corr: Optional[Dict] = None,
) -> torch.Tensor:
    """BN-folded int8-conv inference forward, NHWC in and out (x.dtype).

    scales: {conv_name: scale} calibrated per-conv input scales
    (calibrate_int8), checked to cover every conv of arch; None -> the
    dynamic per-conv path. With static scales the int8 residual carry runs.
    fused_layers routes those layers' identity blocks through the fused
    block kernel; fused_tails routes those layers' block boundaries through
    the fused tail + conv1 kernel. The two target the same convs, so a layer
    may take one of them only. Unlike the JAX package, the fused paths take
    a prepared tree too (weights quantised once, the same bits)."""
    overlap = set(fused_tails or ()) & set(fused_layers or ())
    if overlap:
        raise ValueError(
            f"layers {sorted(overlap)} appear in both fused_layers and "
            "fused_tails; each layer may use at most one fusion scheme"
        )
    if (fused_layers or fused_tails) and any(
        getattr(s, "ndim", 0) >= 1 for s in (scales or {}).values()
    ):
        raise ValueError(
            "per-channel int8 scales (encoder_quant_granularity='channel') are "
            "not supported by the fused Pallas block/tail kernels (they take "
            "scalar carry scales); use granularity='tensor' or fused_*=()"
        )
    if (fused_layers or fused_tails) and bias_corr:
        raise ValueError(
            "int8 bias correction is not applied inside the fused Pallas "
            "block/tail kernels; use encoder_quant_bias_correct=False with "
            "fused layers/tails"
        )
    if scales is not None:
        return _resnet_int8_carry(folded, x, arch, scales, fused_layers, fused_tails,
                                  stem_s2d, bias_corr=bias_corr)
    if fused_layers or fused_tails:
        # the dynamic path never reads the fusion knobs: an accepted but
        # ignored flag would silently time the wrong path
        raise ValueError(
            "int8_fused_layers/int8_fused_tails require calibrated static "
            "scales (int8_scales) — the dynamic per-conv path has no fused "
            "Pallas kernels; calibrate first or pass fused_*=()"
        )
    dt = x.dtype

    def conv(name, xx, p, stride, pad):
        return _conv_i8(xx, p, stride, dt, None, pad)

    return _folded_forward(folded, x, arch, conv)


def _resnet_int8_carry(folded: Dict, x: torch.Tensor, arch: str, scales: Dict,
                       fused_layers=(), fused_tails=(), stem_s2d: bool = False,
                       bias_corr: Optional[Dict] = None, fp_means: Optional[Dict] = None,
                       collect_into: Optional[Dict] = None) -> torch.Tensor:
    """int8-activation-carry forward: inter-block tensors stay s8 + scale.

    Same traversal order and names as _folded_forward (so calibrate_int8's
    scale names match), but the block residual is dequantised from s8 inside
    conv3's epilogue. fused_layers: layers whose identity blocks run the
    fused block kernel. fused_tails: layers whose identity-block tails fuse
    with the next block's conv1; the pair hands the next block its s8 conv1
    activation (z1_pending), so that block starts at conv2.

    fp_means / collect_into (calibrate_int8_bias only): each conv's
    per-channel mean is matched to the fp32 forward's on the fly and the
    delta recorded."""
    dt = x.dtype
    block_type, stages = RESNET_SPECS[arch]
    need = ["conv1"]
    for li, n_blocks in enumerate(stages):
        for bi in range(n_blocks):
            n_convs = 3 if block_type == "bottleneck" else 2
            need += [f"layer{li+1}.{bi}.conv{ci}" for ci in range(1, n_convs + 1)]
            if "downsample" in folded[f"layer{li+1}"][bi]:
                need.append(f"layer{li+1}.{bi}.downsample")
    missing = [n for n in need if n not in scales]
    if missing:
        raise ValueError(
            f"int8 scales missing {len(missing)} convs for arch={arch} "
            f"(e.g. {missing[:3]}); recalibrate with calibrate_int8"
        )
    scales = _device_scales(scales, x)

    if "wq" in folded["conv1"]:
        bias_corr = None  # prepare_encoder_inference already folded it in

    def pre(name, x_s8, x_scale, cp, strd=1, pad=None):
        """int8 conv -> fp32 pre-activation: acc * scale + bias (+ the
        calibrate_int8_bias correction, added into the bias as the prepared
        path folds it)."""
        acc, sc = _acc_i8(x_s8, cp, x_scale, strd, pad)
        bias = cp["bias"].float()
        if bias_corr is not None and name in bias_corr:
            bias = bias + f32(bias_corr[name], bias)
        y = acc.float() * sc + bias
        if fp_means is not None:
            d = fp_means[name] - y.mean(dim=(0, 1, 2))
            collect_into[name] = d
            y = y + d
        return y

    # stem: conv1 + relu, quantise before the max-pool, pool in the s8
    # domain (max commutes with the monotone requant; after relu every
    # window holds an element >= 0, so the -inf padding of the float pool
    # equals the TPU's -128; the pool runs in fp32, which holds s8 exactly)
    p = folded["conv1"]
    s0 = scales["conv1"]
    s_in = scales["layer1.0.conv1"]
    xq = _requant(x.float(), s0)
    even = x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0
    if "wq" in p:
        # prepared stem: the s2d decision is baked into the weight's shape
        # (4x4 = rewritten); the runtime flag must agree
        use_s2d = p["wq"].shape[-1] == 4
        if use_s2d != bool(stem_s2d):
            raise ValueError(
                "stem_s2d flag does not match the prepared stem kernel; re-run "
                "prepare_encoder_inference with the same stem_s2d setting"
            )
        if use_s2d and not even:
            raise ValueError(
                "the prepared stem was space-to-depth-rewritten (4x4 kernel) "
                f"but the input is odd-sized {x.shape[1]}x{x.shape[2]}; re-run "
                "prepare_encoder_inference with stem_s2d=False"
            )
        stem, s0x = p, None
    else:
        # s2d packs 2x2 pixel blocks: odd inputs fall back to the plain 7x7
        use_s2d = bool(stem_s2d) and p["kernel"].shape[-1] == 7 and even
        stem, s0x = _stem_s2d_conv(p, s0) if use_s2d else (p, s0)
    if use_s2d:
        y = F.relu(pre("conv1", _s2d(xq), s0x, stem, 1, ((2, 1), (2, 1))))
    else:
        y = F.relu(pre("conv1", xq, s0x, stem, 2, ((3, 3), (3, 3))))
    y_s8 = _max_pool(_requant(y, s_in).float()).to(torch.int8)

    block_list = [(li, bi) for li, n_blocks in enumerate(stages) for bi in range(n_blocks)]
    z1_pending = None  # next block's s8 conv1 activation from a fused tail
    for idx, (li, bi) in enumerate(block_list):
        p = folded[f"layer{li+1}"][bi]
        nm = f"layer{li+1}.{bi}"
        stride = 2 if (li > 0 and bi == 0) else 1
        last = idx == len(block_list) - 1
        s_out = None if last else scales[
            f"layer{block_list[idx+1][0]+1}.{block_list[idx+1][1]}.conv1"]

        if z1_pending is None and _block_fusable(p, stride, last, fused_layers, f"layer{li+1}"):
            y_s8 = _fused_identity_block(p, y_s8, s_in, scales[f"{nm}.conv2"],
                                         scales[f"{nm}.conv3"], s_out)
            s_in = s_out
            continue

        def mid(name, z_s8, z_scale, cp, strd):  # conv + rescale + bias + relu
            return F.relu(pre(name, z_s8, z_scale, cp, strd))

        if block_type == "bottleneck":
            s2 = scales[f"{nm}.conv2"]
            if z1_pending is not None:
                z2_s8, z1_pending = z1_pending, None  # conv1 already done, fused
            else:
                z2_s8 = _requant(mid(f"{nm}.conv1", y_s8, s_in, p["conv1"], 1), s2)
            z = mid(f"{nm}.conv2", z2_s8, s2, p["conv2"], stride)
            s3 = scales[f"{nm}.conv3"]
            if _tail_fusable(p, stride, last, fused_tails, f"layer{li+1}"):
                nli, nbi = block_list[idx + 1]
                next_p = folded[f"layer{nli+1}"][nbi]
                s_next = scales[f"layer{nli+1}.{nbi}.conv2"]
                y_s8, z1_pending = _fused_tail_pair(p, next_p, y_s8, z, s3, s_in, s_out, s_next)
                s_in = s_out
                continue
            tail = pre(f"{nm}.conv3", _requant(z, s3), s3, p["conv3"])
        else:
            z = mid(f"{nm}.conv1", y_s8, s_in, p["conv1"], stride)
            s2 = scales[f"{nm}.conv2"]
            tail = pre(f"{nm}.conv2", _requant(z, s2), s2, p["conv2"])

        if "downsample" in p:
            shortcut = pre(f"{nm}.downsample", y_s8, s_in, p["downsample"], stride)
            s_sc = scales.get(f"{nm}.downsample_out")
            if s_sc is not None:
                # the shortcut branch stays s8 too (signed: symmetric)
                shortcut = _requant(shortcut, s_sc).float() * f32(s_sc, shortcut)
        else:
            shortcut = y_s8.float() * f32(s_in, tail)  # s8 dequant of the residual

        out = F.relu(tail + shortcut)
        if last:
            return out.to(dt)
        y_s8 = _requant(out, s_out)
        s_in = s_out


# ------------------------------------------------------------ calibration
@contextmanager
def _tf32_off():
    """Full fp32 for a calibration forward on the card: a TF32 conv would
    move every max-abs, and so every scale."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def calibrate_model(model, cf, net, images_u8):
    """One-call int8 calibration: uint8 images -> model with its scales
    (model._replace(int8_scales=..., int8_bias_corr=...)). The one owner of
    the calibration contract: fp32 eval preprocess at train_crop_size, the
    encoder's ResNet, the backbone arch."""
    from adaptive_tpu_torch.ops.preprocess import eval_preprocess

    calib = eval_preprocess(torch.as_tensor(images_u8, device=model.device),
                            cf.train_crop_size, torch.float32)
    scales = calibrate_int8(net.encoder, calib, cf.encoder_backbone,
                            granularity=getattr(cf, "encoder_quant_granularity", "channel"))
    corr = None
    if getattr(cf, "encoder_quant_bias_correct", False):
        corr = calibrate_int8_bias(net.encoder, calib, cf.encoder_backbone, scales)
    return model._replace(int8_scales=scales, int8_bias_corr=corr)


@torch.no_grad()
def calibrate_int8(enc: AttentiveCNN, images: torch.Tensor, arch: str,
                   granularity: str = "tensor") -> Dict[str, Any]:
    """One-shot PTQ calibration: a representative (preprocessed float NHWC)
    batch through the folded fp32 forward, recording each conv input's
    max-abs; returns {conv_name: scale}. granularity='tensor' -> Python
    floats; 'channel' -> np.float32 [Cin] vectors. Each downsample also gets
    '<name>_out', the scale of its output (the s8 shortcut branch)."""
    if granularity not in ("tensor", "channel"):
        raise ValueError(f"granularity={granularity!r} — must be tensor|channel")
    folded = fold_resnet(enc.resnet_conv)
    out: Dict[str, torch.Tensor] = {}

    def amax(t):
        t = t.float().abs()
        return t.amax() if granularity == "tensor" else t.amax(dim=(0, 1, 2))

    def conv(name, xx, p, stride, pad):
        out[name] = amax(xx)
        y = _plain_conv(name, xx, p, stride, pad)
        if name.endswith("downsample"):
            out[name + "_out"] = amax(y)
        return y

    with _tf32_off():
        _folded_forward(folded, images.float(), arch, conv)
    raw = {k: v.cpu().numpy() for k, v in out.items()}
    if granularity == "tensor":
        return {k: max(float(v), 1e-8) / 127.0 for k, v in raw.items()}
    return {k: np.maximum(np.asarray(v, np.float32), 1e-8) / np.float32(127.0)
            for k, v in raw.items()}


@torch.no_grad()
def calibrate_int8_bias(enc: AttentiveCNN, images: torch.Tensor, arch: str,
                        scales: Dict) -> Dict[str, np.ndarray]:
    """Sequential int8 bias correction: per conv, the per-out-channel mean of
    the quantised pre-activation is matched to the fp32 forward's on the
    calibration batch. Pass 1 records the fp32 means; pass 2 walks the real
    int8 carry forward, corrects each conv on the fly and records the deltas,
    so each conv is calibrated against already-corrected inputs. Returns
    {conv_name: np.float32 [Cout]} to add into the conv biases."""
    folded = fold_resnet(enc.resnet_conv)
    xf = images.float()
    means: Dict[str, torch.Tensor] = {}

    def conv(name, xx, p, stride, pad):
        y = _plain_conv(name, xx, p, stride, pad)
        means[name] = y.float().mean(dim=(0, 1, 2))
        return y

    collected: Dict[str, torch.Tensor] = {}
    with _tf32_off():
        _folded_forward(folded, xf, arch, conv)
        _resnet_int8_carry(folded, xf, arch, scales, fp_means=means, collect_into=collected)
    return {k: v.cpu().numpy().astype(np.float32) for k, v in collected.items()}


# ------------------------------------------------------ preparation, entry
@torch.no_grad()
def prepare_encoder_inference(enc: AttentiveCNN, dtype, quant: str = "none",
                              scales: Optional[Dict] = None, stem_s2d: bool = False,
                              bias_corr: Optional[Dict] = None) -> Dict:
    """Once per checkpoint: BN-folded convs and affine heads. The float path
    casts them to dtype. int8 with static scales quantises every conv to
    {'wq', 'scale', 'bias'} (per-channel activation scales folded into the
    kernels, the activation scale combined into 'scale', bias corrections
    added), so the per-batch forward runs no weight pass; the fused kernels
    read the same prepared weights. int8 without scales (the dynamic path)
    keeps the fp32 folded tree."""
    folded = fold_resnet(enc.resnet_conv)
    if quant == "int8" and scales is not None:
        block_type, stages = RESNET_SPECS[enc.resnet_conv.arch]
        n_convs = 3 if block_type == "bottleneck" else 2

        def prep(p, key, x_scale=None):
            wq, sc = _quant_conv_weight(p["kernel"], scales[key] if x_scale is None else x_scale)
            b = p["bias"].float()
            if bias_corr is not None and key in bias_corr:
                b = b + f32(bias_corr[key], b)  # the inline path's association
            return {"wq": wq, "scale": sc, "bias": b}

        stem = folded["conv1"]
        use_s2d = bool(stem_s2d) and stem["kernel"].shape[-1] == 7
        src, s0x = _stem_s2d_conv(stem, scales["conv1"]) if use_s2d else (stem, scales["conv1"])
        out: Dict[str, Any] = {"conv1": prep(src, "conv1", s0x)}
        for li, n_blocks in enumerate(stages):
            blocks = []
            for bi in range(n_blocks):
                p = folded[f"layer{li+1}"][bi]
                nm = f"layer{li+1}.{bi}"
                fp = {f"conv{ci}": prep(p[f"conv{ci}"], f"{nm}.conv{ci}")
                      for ci in range(1, n_convs + 1)}
                if "downsample" in p:
                    fp["downsample"] = prep(p["downsample"], f"{nm}.downsample")
                blocks.append(fp)
            out[f"layer{li+1}"] = blocks
        folded = out
    elif quant != "int8":
        folded = cast_floating(folded, dtype)
    prepared = {"resnet": folded}
    prepared.update(cast_floating(head_params(enc), dtype))
    return prepared


@torch.no_grad()
def encoder_apply_inference(
    enc: Optional[AttentiveCNN], images: torch.Tensor, arch: str, dtype,
    quant: str = "none", scales: Optional[Dict] = None, fused_layers=(), fused_tails=(),
    stem_s2d: bool = False, prepared: Optional[Dict] = None, bias_corr: Optional[Dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Preprocessed float NHWC images -> (V, v_g, h0, c0) in dtype.
    quant='int8' runs the int8 convs (static scales if calibrated, else
    dynamic); fused_layers / fused_tails pick layers for the fused kernels.
    prepared: the tree from prepare_encoder_inference (else the folded,
    unquantised tree is built from enc: the same math, the weight passes
    inline)."""
    if prepared is None:
        prepared = prepare_encoder_inference(enc, dtype, quant)
    if quant == "int8":
        A = resnet_apply_folded_int8(prepared["resnet"], images.to(dtype), arch, scales,
                                     fused_layers, fused_tails, stem_s2d=stem_s2d,
                                     bias_corr=bias_corr)
    else:
        A = resnet_apply_folded(prepared["resnet"], images.to(dtype), arch)
    B, Hf, Wf, C = A.shape
    A_flat = A.reshape(B, Hf * Wf, C)  # slot = h*W + w
    a_g = A_flat.float().mean(dim=1).to(dtype)
    return encoder_heads(prepared, A_flat, a_g)
