"""Plain PyTorch reference of the captioning model: ResNet trunk, the
encoder's affine heads, and the spatial-attention (baseline) and
visual-sentinel (adaptive) decoders of Lu et al., "Knowing When to Look",
CVPR 2017 (arXiv:1612.01887), as the wzn0828/Adaptive code computes them.

Written from the paper and the reference code, in float32, op by op, with
no kernel, cache or batching of the program under test; it imports nothing
of that program. Weights come as a dict keyed by the reference checkpoint's
state_dict names (``param_specs``), the same dict the benchmark loads into
the program.

``Reference(weights, cfg, operand)`` computes every convolution and matrix
product on ``operand(x)`` of its inputs: the identity for the reference, a
rounding to a lower precision for the control (``fp8_operand``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

BOTTLENECK_STAGES = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}
TRUNK = "encoder.resnet_conv"
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5
BN_MOMENTUM = 0.1
FEATURES = 2048  # a bottleneck ResNet's last width


@contextlib.contextmanager
def tf32_off():
    """float32 products in float32: TF32 off for matmuls and cuDNN, restored
    after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8_operand(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude maps to 448), back in float32: the control's precision. The
    gradient passes the rounding unchanged (a straight-through estimator),
    so that products in the backward see the rounded operands."""
    with torch.no_grad():
        scale = 448.0 / x.abs().amax().clamp(min=1e-30)
        q = (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - x).detach()


def slots(cfg: Dict) -> int:
    return (cfg["train_crop_size"] // 32) ** 2


def padded_vocab(cfg: Dict) -> int:
    m = max(1, cfg.get("vocab_pad_multiple", 1))
    return -(-cfg["vocab_length"] // m) * m


def trunk_convs(arch: str):
    """[(name, cin, cout, k, stride, bn name)] of every conv in forward
    order, names below TRUNK; a block's downsample conv after its conv3."""
    out = [("0", 3, 64, 7, 2, "1")]
    cin = 64
    for li, n in enumerate(BOTTLENECK_STAGES[arch]):
        width = 64 * 2 ** li
        cout = 4 * width
        for bi in range(n):
            stride = 2 if (li > 0 and bi == 0) else 1
            p = f"{4 + li}.{bi}"
            out += [(f"{p}.conv1", cin, width, 1, 1, f"{p}.bn1"),
                    (f"{p}.conv2", width, width, 3, stride, f"{p}.bn2"),
                    (f"{p}.conv3", width, cout, 1, 1, f"{p}.bn3")]
            if bi == 0:
                out.append((f"{p}.downsample.0", cin, cout, 1, stride, f"{p}.downsample.1"))
            cin = cout
    return out


def param_specs(cfg: Dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """{state_dict name: (shape, init)}: init is "conv", "linear", "embed",
    "lstm", "zeros", "ones", "bn_count"."""
    E, H = cfg["word_embed_size"], cfg["lstm_hidden_size"]
    D, Vp = slots(cfg), padded_vocab(cfg)
    specs: Dict[str, Tuple[Tuple[int, ...], str]] = {}
    for name, cin, cout, k, _, bn in trunk_convs(cfg["encoder_backbone"]):
        specs[f"{TRUNK}.{name}.weight"] = ((cout, cin, k, k), "conv")
        specs[f"{TRUNK}.{bn}.weight"] = ((cout,), "ones")
        specs[f"{TRUNK}.{bn}.bias"] = ((cout,), "zeros")
        specs[f"{TRUNK}.{bn}.running_mean"] = ((cout,), "zeros")
        specs[f"{TRUNK}.{bn}.running_var"] = ((cout,), "ones")
        specs[f"{TRUNK}.{bn}.num_batches_tracked"] = ((), "bn_count")
    for head, out in (("affine_a", H), ("affine_b", E), ("affine_h0", H), ("affine_c0", H)):
        specs[f"encoder.{head}.weight"] = ((out, FEATURES), "linear")
        specs[f"encoder.{head}.bias"] = ((out,), "zeros")
    specs["decoder.embed.weight"] = ((Vp, E), "embed")
    specs["decoder.LSTM.weight_ih_l0"] = ((4 * H, 2 * E), "lstm")
    specs["decoder.LSTM.weight_hh_l0"] = ((4 * H, H), "lstm")
    specs["decoder.LSTM.bias_ih_l0"] = ((4 * H,), "zeros")
    specs["decoder.LSTM.bias_hh_l0"] = ((4 * H,), "zeros")
    a = "decoder.adaptive"
    if cfg["atten_model_name"] == "adaptive_attention":
        specs[f"{a}.sentinel.affine_x.weight"] = ((H, 2 * E), "linear")
        specs[f"{a}.sentinel.affine_h.weight"] = ((H, H), "linear")
        atten = ("affine_v", "affine_g", "affine_s")
    elif cfg["atten_model_name"] == "baseline_attention":
        atten = ("affine_v", "affine_g")
    else:
        raise ValueError(f"no reference for {cfg['atten_model_name']!r}")
    for n in atten:
        specs[f"{a}.atten.{n}.weight"] = ((D, H), "linear")
    specs[f"{a}.atten.affine_h.weight"] = ((1, D), "linear")
    specs[f"{a}.mlp.weight"] = ((Vp, H), "linear")
    specs[f"{a}.mlp.bias"] = ((Vp,), "zeros")
    return specs


def preprocess_eval(images_u8: torch.Tensor, crop: int) -> torch.Tensor:
    """uint8 NHWC -> NCHW float32: /255, antialiased bilinear resize to crop
    (torchvision's Resize), ImageNet normalisation."""
    x = images_u8.permute(0, 3, 1, 2).float() / 255.0
    if x.shape[-1] != crop:
        x = F.interpolate(x, size=(crop, crop), mode="bilinear", align_corners=False,
                          antialias=True)
    return _normalize(x)


def preprocess_train(images_u8: torch.Tensor, tops, lefts, flips, crop: int) -> torch.Tensor:
    """uint8 NHWC -> NCHW float32: image b's crop x crop window at (tops[b],
    lefts[b]), mirrored left-right where flips[b], /255, normalised."""
    out = []
    for b in range(images_u8.shape[0]):
        t, l = int(tops[b]), int(lefts[b])
        win = images_u8[b, t:t + crop, l:l + crop]
        if bool(flips[b]):
            win = win.flip(1)
        out.append(win)
    x = torch.stack(out).permute(0, 3, 1, 2).float() / 255.0
    return _normalize(x)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(IMAGENET_STD, device=x.device)[None, :, None, None]
    return (x - mean) / std


class Reference:
    """The model on `weights` (state_dict names -> float32 tensors). Train
    mode BN normalises with the batch's moments and appends (bn name, mean,
    unbiased variance) to `bn_moments` when that list is given."""

    def __init__(self, weights: Dict[str, torch.Tensor], cfg: Dict,
                 operand: Callable[[torch.Tensor], torch.Tensor] = identity):
        self.w = weights
        self.cfg = cfg
        self.op = operand
        self.variant = cfg["atten_model_name"]
        self.vocab = cfg["vocab_length"]

    # ------------------------------------------------------------- products
    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.op(a) @ self.op(b)

    def linear(self, x: torch.Tensor, name: str, bias: bool = True) -> torch.Tensor:
        y = self.mm(x, self.w[f"{name}.weight"].T)
        return y + self.w[f"{name}.bias"] if bias else y

    def conv(self, x: torch.Tensor, name: str, stride: int) -> torch.Tensor:
        w = self.w[f"{TRUNK}.{name}.weight"]
        return F.conv2d(self.op(x), self.op(w), None, stride, (w.shape[-1] - 1) // 2)

    # ---------------------------------------------------------------- trunk
    def bn(self, x: torch.Tensor, name: str, train: bool,
           bn_moments: Optional[List] = None) -> torch.Tensor:
        g, b = self.w[f"{TRUNK}.{name}.weight"], self.w[f"{TRUNK}.{name}.bias"]
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            if bn_moments is not None:
                n = x.numel() // x.shape[1]
                bn_moments.append((name, mean.detach(), var.detach() * n / max(n - 1, 1)))
        else:
            mean = self.w[f"{TRUNK}.{name}.running_mean"]
            var = self.w[f"{TRUNK}.{name}.running_var"]
        inv = torch.rsqrt(var + BN_EPS)
        return (x - mean[None, :, None, None]) * (inv * g)[None, :, None, None] + b[None, :, None, None]

    def stem(self, x: torch.Tensor, train: bool, bn_moments=None) -> torch.Tensor:
        y = torch.relu(self.bn(self.conv(x, "0", 2), "1", train, bn_moments))
        return F.max_pool2d(y, 3, 2, 1)

    def block(self, x: torch.Tensor, p: str, stride: int, down: bool, train: bool,
              bn_moments=None) -> torch.Tensor:
        y = torch.relu(self.bn(self.conv(x, f"{p}.conv1", 1), f"{p}.bn1", train, bn_moments))
        y = torch.relu(self.bn(self.conv(y, f"{p}.conv2", stride), f"{p}.bn2", train, bn_moments))
        y = self.bn(self.conv(y, f"{p}.conv3", 1), f"{p}.bn3", train, bn_moments)
        sc = x
        if down:
            sc = self.bn(self.conv(x, f"{p}.downsample.0", stride), f"{p}.downsample.1", train,
                         bn_moments)
        return torch.relu(y + sc)

    def blocks(self):
        """[(layer index 0..3, block prefix, stride, has downsample)]."""
        out = []
        for li, n in enumerate(BOTTLENECK_STAGES[self.cfg["encoder_backbone"]]):
            for bi in range(n):
                out.append((li, f"{4 + li}.{bi}", 2 if (li > 0 and bi == 0) else 1, bi == 0))
        return out

    def trunk(self, x: torch.Tensor, train: bool = False, bn_moments=None) -> torch.Tensor:
        """NCHW float32 images -> NCHW features [B, 2048, H/32, W/32]."""
        y = self.stem(x, train, bn_moments)
        for _, p, stride, down in self.blocks():
            y = self.block(y, p, stride, down, train, bn_moments)
        return y

    # ---------------------------------------------------------------- heads
    def heads(self, A: torch.Tensor):
        """NCHW features -> (V [B,K,H], v_g [B,E], h0, c0 [B,H]); slot k =
        h * W + w, a_g the mean over the slots."""
        A_flat = A.flatten(2).transpose(1, 2)
        a_g = A_flat.mean(dim=1)
        V = torch.relu(self.linear(A_flat, "encoder.affine_a"))
        v_g = torch.relu(self.linear(a_g, "encoder.affine_b"))
        h0 = torch.tanh(self.linear(a_g, "encoder.affine_h0"))
        c0 = torch.tanh(self.linear(a_g, "encoder.affine_c0"))
        return V, v_g, h0, c0

    def encode(self, images_u8: torch.Tensor):
        """Eval-mode encoder of uint8 NHWC images (running BN statistics)."""
        return self.heads(self.trunk(preprocess_eval(images_u8, self.cfg["train_crop_size"])))

    # -------------------------------------------------------------- decoder
    def lstm_step(self, gx: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        """torch.nn.LSTM's cell, gate order i, f, g, o; gx = x W_ih^T + b_ih."""
        gates = gx + self.mm(h, self.w["decoder.LSTM.weight_hh_l0"].T) \
            + self.w["decoder.LSTM.bias_hh_l0"]
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    def attend(self, V: torch.Tensor, pv: torch.Tensor, x: torch.Tensor, h: torch.Tensor,
               c: torch.Tensor, h_prev: torch.Tensor):
        """(a, alpha [B, K], beta [B] or None) of one step of rows [B, .]: a,
        what joins h in the vocab head, is the spatial context (baseline), or
        the sentinel's mix c_hat (adaptive) with sentinel s = sigmoid(x W_x
        + h_prev W_h) tanh(c) and beta its share."""
        a = "decoder.adaptive.atten"
        wh = self.w[f"{a}.affine_h.weight"][0]
        ph = self.linear(h, f"{a}.affine_g", bias=False)  # [B, D]
        z = self.mm(torch.tanh(pv + ph[:, None, :]), wh[:, None])[..., 0]  # [B, K]
        alpha = torch.softmax(z, dim=-1)
        ctx = self.mm(alpha[:, None, :], V)[:, 0]
        if self.variant == "baseline_attention":
            return ctx, alpha, None
        s_name = "decoder.adaptive.sentinel"
        s = torch.sigmoid(self.linear(x, f"{s_name}.affine_x", bias=False)
                          + self.linear(h_prev, f"{s_name}.affine_h", bias=False)) * torch.tanh(c)
        content_s = torch.tanh(self.linear(s, f"{a}.affine_s", bias=False) + ph)
        z_s = self.mm(content_s, wh[:, None])  # [B, 1]
        beta = torch.softmax(torch.cat([z, z_s], dim=-1), dim=-1)[:, -1:]
        return beta * s + (1.0 - beta) * ctx, alpha, beta[:, 0]

    def logits(self, a: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """The vocab head over the real vocabulary."""
        W = self.w["decoder.adaptive.mlp.weight"][: self.vocab]
        return self.mm(a + h, W.T) + self.w["decoder.adaptive.mlp.bias"][: self.vocab]

    def run_decoder(self, V, v_g, h0, c0, tokens: torch.Tensor, sampler: bool):
        """(logits [B, T, vocab], alpha [B, T, K], beta [B, T] or None) of the
        decoder fed tokens [B, T] one step at a time from (h0, c0).
        sampler=True is the caption sampler's step, whose sentinel sees
        h_{t-1} = 0 at every step; False is teacher forcing, where it sees
        the previous step's hidden (zero at the first)."""
        a = "decoder.adaptive.atten"
        pv = self.linear(V, f"{a}.affine_v", bias=False)  # [B, K, D]
        emb = self.w["decoder.embed.weight"][tokens.long()]
        x = torch.cat([emb, v_g[:, None, :].expand_as(emb)], dim=-1)
        gx = self.mm(x, self.w["decoder.LSTM.weight_ih_l0"].T) + self.w["decoder.LSTM.bias_ih_l0"]
        h, c = h0, c0
        logits, alphas, betas = [], [], []
        for t in range(tokens.shape[1]):
            h_prev = torch.zeros_like(h) if (sampler or t == 0) else h
            h, c = self.lstm_step(gx[:, t], h, c)
            a, alpha, beta = self.attend(V, pv, x[:, t], h, c, h_prev)
            logits.append(self.logits(a, h))
            alphas.append(alpha)
            betas.append(beta)
        return (torch.stack(logits, 1), torch.stack(alphas, 1),
                None if betas[0] is None else torch.stack(betas, 1))

    def served_logits(self, images_u8: torch.Tensor, served: torch.Tensor, start: int,
                      features=None):
        """The sampler's (logits, alpha, beta) at each served position (as
        run_decoder's): step t is fed <start> then the served tokens before
        t. served [B, L]; features: encode(images_u8), where already made."""
        V, v_g, h0, c0 = self.encode(images_u8) if features is None else features
        fed = torch.cat([torch.full_like(served[:, :1], start), served[:, :-1]], dim=1)
        return self.run_decoder(V, v_g, h0, c0, fed, sampler=True)


def calibrate_bn(weights: Dict[str, torch.Tensor], cfg: Dict, images_u8: torch.Tensor,
                 residual_gain: float = 0.2) -> None:
    """Set every BN's running statistics, in place, to the moments of its
    input on images_u8 (eval preprocessing), in one forward pass in which
    each BN normalises with the statistics it has just been given; then the
    last BN of each residual branch gets scale residual_gain. The recipe of
    a calibrated random ResNet whose activations keep a trained network's
    scale (adaptive_tpu_torch/models/resnet.py::calibrate_bn_ has it too)."""
    ref = Reference(weights, cfg)

    def bn(x, name, train, bn_moments=None):
        weights[f"{TRUNK}.{name}.running_mean"].copy_(x.mean(dim=(0, 2, 3)))
        weights[f"{TRUNK}.{name}.running_var"].copy_(x.var(dim=(0, 2, 3), unbiased=False))
        return Reference.bn(ref, x, name, False)

    ref.bn = bn
    with torch.no_grad(), tf32_off():
        ref.trunk(preprocess_eval(images_u8, cfg["train_crop_size"]))
        for _, p, _, _ in ref.blocks():
            weights[f"{TRUNK}.{p}.bn3.weight"].fill_(residual_gain)


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Random float32 weights from seed, on device, in two draws: one normal
    vector for every weight, scaled per tensor (convs: He normal over
    fan-out; linears and the LSTM: 1/sqrt(fan-in), the tanh gain for the
    initial-state heads; embedding N(0, 1)), and constants for the BN
    parameters and biases (the LSTM's forget-gate biases 0.5)."""
    specs = param_specs(cfg)
    drawn = [(n, s) for n, (s, init) in specs.items() if init in ("conv", "linear", "embed", "lstm")]
    total = sum(math.prod(s) for _, s in drawn)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    w: Dict[str, torch.Tensor] = {}
    off = 0
    for name, shape in drawn:
        n = math.prod(shape)
        init = specs[name][1]
        if init == "conv":
            std = math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
        elif init == "embed":
            std = 1.0
        else:
            std = 1.0 / math.sqrt(shape[1])
            if "affine_h0" in name or "affine_c0" in name:
                std *= 5.0 / 3.0
        w[name] = flat[off:off + n].view(shape).mul_(std)
        off += n
    for name, (shape, init) in specs.items():
        if init == "zeros":
            w[name] = torch.zeros(shape, device=device)
        elif init == "ones":
            w[name] = torch.ones(shape, device=device)
        elif init == "bn_count":
            w[name] = torch.zeros(shape, dtype=torch.long, device=device)
    H = cfg["lstm_hidden_size"]
    for b in ("decoder.LSTM.bias_ih_l0", "decoder.LSTM.bias_hh_l0"):
        w[b][H:2 * H] = 0.5
    return {n: w[n] for n in specs}
