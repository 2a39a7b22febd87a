"""Plain PyTorch reference of granite-4.0-h-micro as a caption decoder
(IBM, https://huggingface.co/ibm-granite/granite-4.0-h-micro, model_type
granitemoehybrid): the ResNet trunk's map through a two-layer projector
becomes image tokens, and the language model's forward runs over them and
the caption's tokens in one pass.

    image tokens = W2 gelu(W1 A + b1) + b2        (A: the trunk map's slots)
    h = embedding_multiplier * [image tokens, E[ids]]
    layer l:  h = h + r * Mixer_l(RMSNorm(h))
              h = h + r * W_out(silu(g) * u),  [g, u] = W_in RMSNorm(h)
    logits = RMSNorm(h) E^T / logits_scaling

Mamba-2 mixer: [z, xBC, dt] = in_proj(x); xBC = silu(causal depthwise
conv1d(xBC) + bias), split into x, B, C; dt = softplus(dt + dt_bias),
A = -exp(A_log); then, position by position, per head S = exp(dt A) S +
dt x B^T and y = S C + D x; y = RMSNorm(y * silu(z)) w over all channels,
then out_proj. Attention mixer: q/k/v projections, no rotary embedding,
causal softmax(q k^T * attention_multiplier) with num_key_value_heads
groups of query heads, o_proj.

Written from Hugging Face's GraniteMoeHybrid modelling, in float32 (TF32
off), op by op, with no cache, kernel or batching of the program under
test; it imports nothing of that program. The trunk is
benchmark/reference/model.py's. Departures from Hugging Face's model:

* the image tokens enter as inputs_embeds, which Hugging Face scales by
  embedding_multiplier as it scales the words' embeddings;
* no padding or attention mask: every row has the same length;
* Mamba-2 runs as its recurrence, one position at a time, where Hugging
  Face's torch path runs the chunked scan: the same mathematics;
* dt's clamp to time_step_limit, (0, inf) by default, is left out: softplus
  is positive and finite;
* the head reads the tied embedding; there is no lm_head tensor.

Weights come as a dict keyed by the program's state_dict names
(``param_specs``): the trunk under encoder.resnet_conv, the projector as
projector.{0,2}, the language model under lm. with Hugging Face's names.
``make_weights`` draws them from a seed (``make_trunk_weights`` and
``make_lm_weights``, apart, so that either can be drawn again alone).

``HybridReference(weights, cfg, operand)`` computes every convolution and
matrix product on ``operand(x)`` of its inputs: the identity for the
reference, a rounding to a lower precision for a control.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.model import (
    FEATURES, TRUNK, Reference, identity, preprocess_eval, tf32_off, trunk_convs,
)

LM_SEED_OFFSET = 7919  # the language model's generator: seed + this


def sizes(cfg: Dict) -> Dict:
    """The language model's sizes from the configuration's published keys."""
    H, P, N, G = (cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"],
                  cfg["mamba_n_groups"])
    D = cfg["hidden_size"]
    return {"D": D, "I": cfg["shared_intermediate_size"], "types": list(cfg["layer_types"]),
            "heads": cfg["num_attention_heads"], "kv": cfg["num_key_value_heads"],
            "hd": D // cfg["num_attention_heads"], "H": H, "P": P, "N": N, "G": G,
            "K": cfg["mamba_d_conv"], "inner": H * P, "conv": H * P + 2 * G * N,
            "V": cfg["vocab_length"], "F": FEATURES}


def param_specs(cfg: Dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """{state_dict name: (shape, init)}: init is "conv" (the trunk's),
    "ones", "zeros", "bn_count", "normal" (N(0, 0.02)), "conv1d" (U(+-1 /
    sqrt(d_conv))), "A_log" or "dt_bias"."""
    s = sizes(cfg)
    specs: Dict[str, Tuple[Tuple[int, ...], str]] = {}
    for name, cin, cout, k, _, bn in trunk_convs(cfg["encoder_backbone"]):
        specs[f"{TRUNK}.{name}.weight"] = ((cout, cin, k, k), "conv")
        specs[f"{TRUNK}.{bn}.weight"] = ((cout,), "ones")
        specs[f"{TRUNK}.{bn}.bias"] = ((cout,), "zeros")
        specs[f"{TRUNK}.{bn}.running_mean"] = ((cout,), "zeros")
        specs[f"{TRUNK}.{bn}.running_var"] = ((cout,), "ones")
        specs[f"{TRUNK}.{bn}.num_batches_tracked"] = ((), "bn_count")
    D = s["D"]
    specs["projector.0.weight"] = ((D, s["F"]), "normal")
    specs["projector.0.bias"] = ((D,), "zeros")
    specs["projector.2.weight"] = ((D, D), "normal")
    specs["projector.2.bias"] = ((D,), "zeros")
    specs["lm.model.embed_tokens.weight"] = ((s["V"], D), "normal")
    for i, kind in enumerate(s["types"]):
        p = f"lm.model.layers.{i}"
        specs[f"{p}.input_layernorm.weight"] = ((D,), "ones")
        if kind == "mamba":
            m = f"{p}.mamba"
            specs[f"{m}.dt_bias"] = ((s["H"],), "dt_bias")
            specs[f"{m}.A_log"] = ((s["H"],), "A_log")
            specs[f"{m}.D"] = ((s["H"],), "ones")
            specs[f"{m}.in_proj.weight"] = ((2 * s["inner"] + 2 * s["G"] * s["N"] + s["H"], D),
                                            "normal")
            specs[f"{m}.conv1d.weight"] = ((s["conv"], 1, s["K"]), "conv1d")
            specs[f"{m}.conv1d.bias"] = ((s["conv"],), "conv1d")
            specs[f"{m}.norm.weight"] = ((s["inner"],), "ones")
            specs[f"{m}.out_proj.weight"] = ((D, s["inner"]), "normal")
        else:
            a = f"{p}.self_attn"
            kv = s["kv"] * s["hd"]
            for n, shape in (("q_proj", (D, D)), ("k_proj", (kv, D)), ("v_proj", (kv, D)),
                             ("o_proj", (D, D))):
                specs[f"{a}.{n}.weight"] = (shape, "normal")
        specs[f"{p}.shared_mlp.input_linear.weight"] = ((2 * s["I"], D), "normal")
        specs[f"{p}.shared_mlp.output_linear.weight"] = ((D, s["I"]), "normal")
        specs[f"{p}.post_attention_layernorm.weight"] = ((D,), "ones")
    specs["lm.model.norm.weight"] = ((D,), "ones")
    return specs


def _constant(shape, init, device):
    if init == "zeros":
        return torch.zeros(shape, device=device)
    if init == "ones":
        return torch.ones(shape, device=device)
    return torch.zeros(shape, dtype=torch.long, device=device)  # bn_count


def make_trunk_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The trunk's float32 weights from seed: each conv He normal over its
    fan-out (benchmark/reference/model.py's draw), BN constants (calibrate
    them with model.calibrate_bn)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for name, (shape, init) in param_specs(cfg).items():
        if not name.startswith(TRUNK):
            continue
        if init == "conv":
            std = math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
            out[name] = torch.empty(shape, device=device).normal_(0.0, std, generator=gen)
        else:
            out[name] = _constant(shape, init, device)
    return out


def make_lm_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The projector's and the language model's float32 weights from seed
    (their own generator, seed + LM_SEED_OFFSET), mamba_ssm's Mamba-2 init:
    linears and the embedding N(0, 0.02), biases 0, the depthwise conv (and
    its bias) torch's Conv1d default U(+-1 / sqrt(d_conv)), A_log = log U(1,
    16), dt_bias = softplus^-1(dt) with dt log-uniform in [1e-3, 1e-1], D
    and the norms 1."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + LM_SEED_OFFSET)
    K = cfg["mamba_d_conv"]
    out = {}
    for name, (shape, init) in param_specs(cfg).items():
        if name.startswith(TRUNK):
            continue
        t = torch.empty(shape, device=device)
        if init == "normal":
            t.normal_(0.0, 0.02, generator=gen)
        elif init == "conv1d":
            t.uniform_(-1.0 / math.sqrt(K), 1.0 / math.sqrt(K), generator=gen)
        elif init == "A_log":
            t = t.uniform_(1.0, 16.0, generator=gen).log()
        elif init == "dt_bias":
            u = t.uniform_(generator=gen)
            dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
            t = dt + torch.log(-torch.expm1(-dt))
        else:
            t = _constant(shape, init, device)
        out[name] = t
    return out


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight, in param_specs' order (the trunk's BN uncalibrated)."""
    w = dict(make_trunk_weights(cfg, seed, device), **make_lm_weights(cfg, seed, device))
    return {n: w[n] for n in param_specs(cfg)}


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


class HybridReference:
    """The model on `weights` (float32 tensors under param_specs' names)."""

    def __init__(self, weights: Dict[str, torch.Tensor], cfg: Dict,
                 operand: Callable[[torch.Tensor], torch.Tensor] = identity):
        self.w, self.cfg, self.op = weights, cfg, operand
        self.s = sizes(cfg)
        self.eps = cfg["rms_norm_eps"]

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.op(a) @ self.op(b)

    def linear(self, x: torch.Tensor, name: str, bias: bool = False) -> torch.Tensor:
        y = self.mm(x, self.w[f"{name}.weight"].T)
        return y + self.w[f"{name}.bias"] if bias else y

    # ------------------------------------------------------------ image tokens
    def trunk_map(self, images_u8: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC images -> the eval-mode trunk's map [B, slots, 2048]
        (slot = h * W + w)."""
        with tf32_off():
            x = preprocess_eval(images_u8, self.cfg["train_crop_size"])
            A = Reference(self.w, self.cfg, self.op).trunk(x)
        return A.flatten(2).transpose(1, 2)

    def image_tokens(self, A_flat: torch.Tensor) -> torch.Tensor:
        """The projector: Linear, exact GELU, Linear."""
        with tf32_off():
            return self.linear(F.gelu(self.linear(A_flat, "projector.0", bias=True)),
                               "projector.2", bias=True)

    # ------------------------------------------------------------ the LM
    def mamba(self, x: torch.Tensor, p: str) -> torch.Tensor:
        s = self.s
        B, L, _ = x.shape
        H, P, N, G, K = s["H"], s["P"], s["N"], s["G"], s["K"]
        z, xbc, dt = self.linear(x, f"{p}.in_proj").split([s["inner"], s["conv"], H], dim=-1)
        w = self.op(self.w[f"{p}.conv1d.weight"][:, 0])  # [C, K]
        pad = self.op(F.pad(xbc, (0, 0, K - 1, 0)))
        conv = self.w[f"{p}.conv1d.bias"] + sum(w[:, k] * pad[:, k:k + L] for k in range(K))
        xs, Bm, Cm = F.silu(conv).split([s["inner"], G * N, G * N], dim=-1)
        xs = xs.reshape(B, L, H, P)
        Bm = Bm.reshape(B, L, G, N).repeat_interleave(H // G, dim=2)  # [B, L, H, N]
        Cm = Cm.reshape(B, L, G, N).repeat_interleave(H // G, dim=2)
        dt = F.softplus(dt + self.w[f"{p}.dt_bias"])  # [B, L, H]
        A = -torch.exp(self.w[f"{p}.A_log"])
        D = self.w[f"{p}.D"]
        S = torch.zeros(B, H, P, N, device=x.device)
        ys = []
        for t in range(L):
            S = (torch.exp(dt[:, t] * A)[:, :, None, None] * S
                 + (dt[:, t, :, None] * xs[:, t])[..., None] * Bm[:, t, :, None, :])
            y = self.mm(S, Cm[:, t, :, :, None])[..., 0] + D[:, None] * xs[:, t]
            ys.append(y.reshape(B, H * P))
        y = torch.stack(ys, dim=1) * F.silu(z)
        y = rms_norm(y, self.w[f"{p}.norm.weight"], self.eps)
        return self.linear(y, f"{p}.out_proj")

    def attention(self, x: torch.Tensor, p: str) -> torch.Tensor:
        s = self.s
        B, L, _ = x.shape
        hd, kv, rep = s["hd"], s["kv"], s["heads"] // s["kv"]
        q = self.linear(x, f"{p}.q_proj").reshape(B, L, kv, rep, hd).permute(0, 2, 3, 1, 4)
        k = self.linear(x, f"{p}.k_proj").reshape(B, L, kv, 1, hd).permute(0, 2, 3, 1, 4)
        v = self.linear(x, f"{p}.v_proj").reshape(B, L, kv, 1, hd).permute(0, 2, 3, 1, 4)
        scores = self.mm(q, k.transpose(-1, -2)) * self.cfg["attention_multiplier"]
        future = torch.ones(L, L, dtype=torch.bool, device=x.device).triu(1)
        a = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
        o = self.mm(a, v).permute(0, 3, 1, 2, 4).reshape(B, L, s["D"])
        return self.linear(o, f"{p}.o_proj")

    def logits(self, image_tokens: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """The forward over [image_tokens [B, K, D], the embeddings of ids
        [B, T]] in one pass: the logits [B, T, vocab] at the ids' positions
        (position K + t predicts what follows ids[:, t])."""
        c, r = self.cfg, self.cfg["residual_multiplier"]
        E = self.w["lm.model.embed_tokens.weight"]
        K = image_tokens.shape[1]
        with tf32_off():
            h = torch.cat([image_tokens, E[ids.long()]], dim=1) * c["embedding_multiplier"]
            for i, kind in enumerate(self.s["types"]):
                p = f"lm.model.layers.{i}"
                x = rms_norm(h, self.w[f"{p}.input_layernorm.weight"], self.eps)
                h = h + r * (self.mamba(x, f"{p}.mamba") if kind == "mamba"
                             else self.attention(x, f"{p}.self_attn"))
                x = rms_norm(h, self.w[f"{p}.post_attention_layernorm.weight"], self.eps)
                g, u = self.linear(x, f"{p}.shared_mlp.input_linear").chunk(2, dim=-1)
                h = h + r * self.linear(F.silu(g) * u, f"{p}.shared_mlp.output_linear")
            out = rms_norm(h[:, K:], self.w["lm.model.norm.weight"], self.eps)
            return self.mm(out, E.T) / c["logits_scaling"]

    def served_logits(self, image_tokens: torch.Tensor, served: torch.Tensor,
                      start: int) -> torch.Tensor:
        """The logits at each served position [B, L, vocab]: position t is
        fed <start> then the served tokens before t."""
        fed = torch.cat([torch.full_like(served[:, :1], start), served[:, :-1]], dim=1)
        return self.logits(image_tokens, fed)
