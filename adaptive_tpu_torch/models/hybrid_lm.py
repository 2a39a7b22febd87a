"""granite-4.0-h-micro as a caption decoder: a hybrid Mamba-2 / attention
language model over image tokens (the ``granite_h_micro`` variant; the JAX
package has no counterpart).

The ResNet trunk's final map [B, 7, 7, 2048] goes through a two-layer
projector (LLaVA-1.5's ``mlp2x_gelu``: Linear, GELU, Linear) and becomes 49
image tokens, which are prefilled; greedy decoding then writes the caption
from ``decode_start_token``. The language model is Hugging Face's
``GraniteMoeHybridForCausalLM`` with no experts:

    h = embedding_multiplier * inputs_embeds       (image tokens and words alike)
    layer l:  h = h + r * Mixer_l(RMSNorm(h))
              h = h + r * W_out(silu(g) * u),  [g, u] = W_in RMSNorm(h)
    logits = RMSNorm(h) E^T / logits_scaling       (E: the tied embedding)

with r = residual_multiplier. A Mamba-2 mixer: [z, xBC, dt] = in_proj(x);
xBC = silu(causal depthwise conv1d(xBC) + bias), split into x, B, C;
dt = softplus(dt + dt_bias), A = -exp(A_log); per head S <- exp(dt A) S +
dt x B^T and y = S C + D x; then y = RMSNorm(y * silu(z)) w over all
channels and out_proj(y). An attention mixer: q/k/v projections, no
rotary embedding (NoPE), causal softmax at scale attention_multiplier,
grouped KV heads, o_proj.

``HybridNet`` holds the weights under the reference names: the trunk as
``encoder.resnet_conv.*`` (fp32, for the BN fold), ``projector.{0,2}.*`` and
the language model under ``lm.`` with Hugging Face's names
(``lm.model.layers.5.self_attn.q_proj.weight``; the head is tied to
``lm.model.embed_tokens``), both in the compute dtype: the variant is
inference-only, so the decode reads the module's own tensors and
``prepare_inference`` copies only the few it lays out anew.

The decode keeps a ``HybridCache`` of two kinds: per Mamba layer an SSM
state [B, H, P, N] and a conv state [B, d_conv - 1, conv_dim] (the last raw
xBC inputs), per attention layer a KV cache [B, kv_heads, positions, d].
The prefill (ops/ssd.py: the causal conv and the chunked SSD scan) fills it;
each decode step runs kernel 8 (ops/ssm_step.py) on every Mamba layer.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from adaptive_tpu_torch.config import unsupported
from adaptive_tpu_torch.models.infer import cast_floating, fold_resnet, resnet_apply_folded
from adaptive_tpu_torch.models.resnet import ResNet, feature_channels, init_resnet_
from adaptive_tpu_torch.ops import ssd
from adaptive_tpu_torch.ops import ssm_step as SS
from adaptive_tpu_torch.utils.profiling import span

# granite-4.0-h-micro's config.json (https://huggingface.co/ibm-granite/
# granite-4.0-h-micro), the keys this module reads
PUBLISHED: Dict[str, Any] = {
    "hidden_size": 2048,
    "shared_intermediate_size": 8192,
    "layer_types": (["mamba"] * 5 + ["attention"] + ["mamba"] * 9 + ["attention"]
                    + ["mamba"] * 9 + ["attention"] + ["mamba"] * 9 + ["attention"]
                    + ["mamba"] * 4),
    "num_attention_heads": 32,
    "num_key_value_heads": 8,
    "attention_multiplier": 0.015625,
    "attention_bias": False,
    "position_embedding_type": "nope",
    "mamba_n_heads": 64,
    "mamba_d_head": 64,
    "mamba_d_state": 128,
    "mamba_n_groups": 1,
    "mamba_d_conv": 4,
    "mamba_expand": 2,
    "mamba_chunk_size": 256,
    "mamba_conv_bias": True,
    "mamba_proj_bias": False,
    "embedding_multiplier": 12.0,
    "residual_multiplier": 0.22,
    "logits_scaling": 8.0,
    "rms_norm_eps": 1e-5,
    "hidden_act": "silu",
    "tie_word_embeddings": True,
    "num_local_experts": 0,
}
# what this module computes; another value of these keys raises
FIXED = {"attention_bias": False, "position_embedding_type": "nope", "mamba_conv_bias": True,
         "mamba_proj_bias": False, "hidden_act": "silu", "tie_word_embeddings": True,
         "num_local_experts": 0}


class LMSpec(NamedTuple):
    hidden: int
    mlp: int  # shared_intermediate_size
    layer_types: Tuple[str, ...]
    heads: int
    kv_heads: int
    head_dim: int
    attn_scale: float
    m_heads: int  # Mamba heads H, each of width P = m_head_dim
    m_head_dim: int
    d_state: int  # N
    groups: int  # G: B and C are shared by H / G heads
    d_conv: int
    chunk: int
    embed_mult: float
    residual_mult: float
    logits_scaling: float
    eps: float
    vocab: int

    @property
    def d_inner(self) -> int:
        return self.m_heads * self.m_head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.groups * self.d_state

    @property
    def in_proj(self) -> int:
        return 2 * self.d_inner + 2 * self.groups * self.d_state + self.m_heads

    def slots(self) -> List[Tuple[str, int]]:
        """(kind, index among the layers of its kind) of each layer."""
        seen = {"mamba": 0, "attention": 0}
        out = []
        for kind in self.layer_types:
            out.append((kind, seen[kind]))
            seen[kind] += 1
        return out


def lm_spec(cf) -> LMSpec:
    """The language model's sizes: PUBLISHED with cf.hybrid_lm's keys over
    it, the vocabulary cf.vocab_length. Raises on an unknown key and on a
    value of FIXED's keys this module does not compute."""
    over = dict(cf.hybrid_lm or {})
    unknown = set(over) - set(PUBLISHED)
    if unknown:
        raise KeyError(f"hybrid_lm keys unknown to {cf.atten_model_name}: {sorted(unknown)}")
    c = dict(PUBLISHED, **over)
    for k, v in FIXED.items():
        if c[k] != v:
            raise NotImplementedError(f"hybrid_lm {k}={c[k]!r}: only {v!r} is implemented")
    types = tuple(c["layer_types"])
    if set(types) - {"mamba", "attention"}:
        raise ValueError(f"hybrid_lm layer_types must be 'mamba' or 'attention', got {types}")
    D, heads = c["hidden_size"], c["num_attention_heads"]
    if D % heads or heads % c["num_key_value_heads"]:
        raise ValueError(f"hybrid_lm: {heads} heads must divide hidden_size {D} and be a "
                         f"multiple of num_key_value_heads {c['num_key_value_heads']}")
    if c["mamba_n_heads"] % c["mamba_n_groups"]:
        raise ValueError("hybrid_lm: mamba_n_groups must divide mamba_n_heads")
    if c["mamba_n_heads"] * c["mamba_d_head"] != c["mamba_expand"] * D:
        raise ValueError("hybrid_lm: mamba_n_heads * mamba_d_head must be mamba_expand * "
                         "hidden_size")
    return LMSpec(hidden=D, mlp=c["shared_intermediate_size"], layer_types=types, heads=heads,
                  kv_heads=c["num_key_value_heads"], head_dim=D // heads,
                  attn_scale=float(c["attention_multiplier"]), m_heads=c["mamba_n_heads"],
                  m_head_dim=c["mamba_d_head"], d_state=c["mamba_d_state"],
                  groups=c["mamba_n_groups"], d_conv=c["mamba_d_conv"],
                  chunk=c["mamba_chunk_size"], embed_mult=float(c["embedding_multiplier"]),
                  residual_mult=float(c["residual_multiplier"]),
                  logits_scaling=float(c["logits_scaling"]), eps=float(c["rms_norm_eps"]),
                  vocab=cf.vocab_length)


# ------------------------------------------------------------------ modules
class RMSNorm(nn.Module):
    def __init__(self, n: int, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n, dtype=dtype))


class MambaMixer(nn.Module):
    def __init__(self, s: LMSpec, dtype):
        super().__init__()
        self.in_proj = nn.Linear(s.hidden, s.in_proj, bias=False, dtype=dtype)
        self.conv1d = nn.Conv1d(s.conv_dim, s.conv_dim, s.d_conv, groups=s.conv_dim,
                                padding=s.d_conv - 1, dtype=dtype)
        self.dt_bias = nn.Parameter(torch.ones(s.m_heads, dtype=dtype))
        self.A_log = nn.Parameter(torch.zeros(s.m_heads, dtype=dtype))
        self.D = nn.Parameter(torch.ones(s.m_heads, dtype=dtype))
        self.norm = RMSNorm(s.d_inner, dtype)
        self.out_proj = nn.Linear(s.d_inner, s.hidden, bias=False, dtype=dtype)


class Attention(nn.Module):
    def __init__(self, s: LMSpec, dtype):
        super().__init__()
        kv = s.kv_heads * s.head_dim
        self.q_proj = nn.Linear(s.hidden, s.hidden, bias=False, dtype=dtype)
        self.k_proj = nn.Linear(s.hidden, kv, bias=False, dtype=dtype)
        self.v_proj = nn.Linear(s.hidden, kv, bias=False, dtype=dtype)
        self.o_proj = nn.Linear(s.hidden, s.hidden, bias=False, dtype=dtype)


class SharedMLP(nn.Module):
    def __init__(self, s: LMSpec, dtype):
        super().__init__()
        self.input_linear = nn.Linear(s.hidden, 2 * s.mlp, bias=False, dtype=dtype)
        self.output_linear = nn.Linear(s.mlp, s.hidden, bias=False, dtype=dtype)


class HybridLayer(nn.Module):
    def __init__(self, s: LMSpec, kind: str, dtype):
        super().__init__()
        self.input_layernorm = RMSNorm(s.hidden, dtype)
        if kind == "mamba":
            self.mamba = MambaMixer(s, dtype)
        else:
            self.self_attn = Attention(s, dtype)
        self.shared_mlp = SharedMLP(s, dtype)
        self.post_attention_layernorm = RMSNorm(s.hidden, dtype)


class _Body(nn.Module):
    def __init__(self, s: LMSpec, dtype):
        super().__init__()
        self.embed_tokens = nn.Embedding(s.vocab, s.hidden, dtype=dtype)
        self.layers = nn.ModuleList(HybridLayer(s, k, dtype) for k in s.layer_types)
        self.norm = RMSNorm(s.hidden, dtype)


class HybridLM(nn.Module):
    """GraniteMoeHybridForCausalLM's parameters (tied head: no lm_head)."""

    def __init__(self, s: LMSpec, dtype):
        super().__init__()
        self.model = _Body(s, dtype)


class _Trunk(nn.Module):
    def __init__(self, arch: str):
        super().__init__()
        self.resnet_conv = ResNet(arch)


class HybridNet(nn.Module):
    """encoder.resnet_conv (fp32), projector and lm (the compute dtype)."""

    def __init__(self, s: LMSpec, arch: str, dtype):
        super().__init__()
        self.encoder = _Trunk(arch)
        C = feature_channels(arch)
        self.projector = nn.Sequential(nn.Linear(C, s.hidden, dtype=dtype), nn.GELU(),
                                       nn.Linear(s.hidden, s.hidden, dtype=dtype))
        self.lm = HybridLM(s, dtype)
        self.d_conv = s.d_conv

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        """The seeded init of mamba_ssm's Mamba-2 (the decay spectrum of a
        trained model's kind): linears and the embedding N(0, 0.02), biases
        0; the conv at torch's Conv1d default U(+-1/sqrt(d_conv)); A_log =
        log U(1, 16); dt_bias = softplus^-1(dt), dt log-uniform in [1e-3,
        1e-1]; D and the norms 1. The trunk as models/resnet.py draws it."""
        init_resnet_(self.encoder.resnet_conv, gen)
        for name, p in self.named_parameters():
            if name.startswith("encoder."):
                continue
            dev = p.device
            if name.endswith(("norm.weight", "layernorm.weight", ".D")):
                p.fill_(1.0)
            elif name.endswith("A_log"):
                a = torch.empty(p.shape, device=dev).uniform_(1.0, 16.0, generator=gen)
                p.copy_(a.log())
            elif name.endswith("dt_bias"):
                u = torch.empty(p.shape, device=dev).uniform_(generator=gen)
                dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
                p.copy_(dt + torch.log(-torch.expm1(-dt)))
            elif "conv1d" in name:  # weight [conv_dim, 1, d_conv], fan-in d_conv
                bound = 1.0 / math.sqrt(self.d_conv)
                p.copy_(torch.empty(p.shape, device=dev).uniform_(-bound, bound, generator=gen))
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.copy_(torch.empty(p.shape, device=dev).normal_(0.0, 0.02, generator=gen))


# ------------------------------------------------------------------ the cache
class HybridCache:
    """The decode state of a batch: per Mamba layer an SSM state [B, H, P, N]
    and a conv state [B, d_conv - 1, conv_dim]; per attention layer keys and
    values [B, kv_heads, positions, head_dim]; pos, the positions filled.
    One tensor a kind, the layers of the kind along dim 0, allocated for the
    batch at prefill in the compute dtype (the SSM state in bf16 in a bf16
    decode, as Hugging Face's and vLLM's Mamba caches hold it)."""

    def __init__(self, s: LMSpec, batch: int, positions: int, dtype, device):
        n_m = sum(k == "mamba" for k in s.layer_types)
        n_a = len(s.layer_types) - n_m
        self.ssm = torch.empty((n_m, batch, s.m_heads, s.m_head_dim, s.d_state), dtype=dtype,
                               device=device)
        self.conv = torch.empty((n_m, batch, s.d_conv - 1, s.conv_dim), dtype=dtype,
                                device=device)
        self.k = torch.empty((n_a, batch, s.kv_heads, positions, s.head_dim), dtype=dtype,
                             device=device)
        self.v = torch.empty_like(self.k)
        self.pos = 0

    def nbytes(self) -> Dict[str, int]:
        """Bytes of each kind: ssm, conv and kv (keys and values)."""
        size = lambda t: t.numel() * t.element_size()  # noqa: E731
        return {"ssm": size(self.ssm), "conv": size(self.conv),
                "kv": size(self.k) + size(self.v)}


# ------------------------------------------------------------------ the math
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Hugging Face's GraniteMoeHybridRMSNorm, x * rsqrt(mean(x^2) + eps) *
    w, as one torch.nn.functional.rms_norm: fp32 inside, one rounding to x's
    dtype (Hugging Face rounds once more, before the weight)."""
    return F.rms_norm(x, (x.shape[-1],), w, eps)


def gated_rms_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """GraniteMoeHybridRMSNormGated over the whole width: RMSNorm(y *
    silu(z)) * w, silu in z's dtype, the product and the norm in fp32,
    rounded once to w's dtype."""
    h = y.float() * F.silu(z)
    return F.rms_norm(h, (h.shape[-1],), w.float(), eps).to(w.dtype)


def _mlp(p: Dict, x: torch.Tensor) -> torch.Tensor:
    g, u = F.linear(x, p["mlp_in"]).chunk(2, dim=-1)
    return F.linear(F.silu(g) * u, p["mlp_out"])


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
            causal: bool) -> torch.Tensor:
    """q [B, KV, rep, Lq, d], k and v [B, KV, Lk, d] -> [B, KV, rep, Lq, d]:
    softmax(q k^T * scale) v with fp32 scores and softmax, as Hugging
    Face's eager attention; causal masks key j > query i (Lq == Lk)."""
    s = torch.matmul(q, k.unsqueeze(2).transpose(-1, -2)).float() * scale
    if causal:
        L = s.shape[-1]
        s = s.masked_fill(torch.ones(L, L, dtype=torch.bool, device=s.device).triu(1),
                          float("-inf"))
    return torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v.unsqueeze(2))


def _detached(tree: Any) -> Any:
    """tree with every tensor detached (the module's parameters as plain
    tensors: the decode records no graph)."""
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detached(v) for v in tree)
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


class HybridModel(NamedTuple):
    """The granite_h_micro variant: build_model's counterpart of
    CaptionModel for the greedy path (decoding/greedy.py)."""

    variant: str
    arch: str
    lm: LMSpec
    compute_dtype: torch.dtype
    device: torch.device

    def new_net(self) -> HybridNet:
        """An uninitialised HybridNet on self.device (its tensors allocated,
        not drawn)."""
        with torch.device("meta"):
            net = HybridNet(self.lm, self.arch, self.compute_dtype)
        return net.to_empty(device=self.device).eval()

    def init(self, seed: int = 0) -> HybridNet:
        net = self.new_net()
        net.init_(torch.Generator(device=self.device).manual_seed(seed))
        return net

    # ------------------------------------------------------------ preparation
    @torch.no_grad()
    def prepare_inference(self, net: HybridNet, mesh=None) -> Dict:
        """{'encoder': the BN-folded trunk in the compute dtype, 'projector',
        'lm': the layers' weights as the decode reads them}. The language
        model's tensors are the module's own (already in the compute dtype)
        but for a few: q/k/v as one matrix, the conv weight as [conv_dim,
        d_conv], and A = -exp(A_log), dt_bias and D in fp32."""
        if mesh is not None:
            raise unsupported(self.variant, "a decode over a device mesh")
        dt = self.compute_dtype
        enc = cast_floating(fold_resnet(net.encoder.resnet_conv), dt)
        proj = [(m.weight.to(dt), m.bias.to(dt)) for m in (net.projector[0], net.projector[2])]
        body = net.lm.model
        layers = []
        for layer in body.layers:
            p = {"norm_in": layer.input_layernorm.weight, "norm_mlp":
                 layer.post_attention_layernorm.weight,
                 "mlp_in": layer.shared_mlp.input_linear.weight,
                 "mlp_out": layer.shared_mlp.output_linear.weight}
            if hasattr(layer, "mamba"):
                m = layer.mamba
                p.update(in_proj=m.in_proj.weight, conv_w=m.conv1d.weight[:, 0].contiguous(),
                         conv_b=m.conv1d.bias, norm=m.norm.weight, out_proj=m.out_proj.weight)
            else:
                a = layer.self_attn
                p.update(qkv=torch.cat([a.q_proj.weight, a.k_proj.weight, a.v_proj.weight]),
                         o_proj=a.o_proj.weight)
            p = cast_floating(p, dt)
            if hasattr(layer, "mamba"):
                p.update(dt_bias=m.dt_bias.float(), A=-torch.exp(m.A_log.float()), D=m.D.float())
            layers.append(p)
        lm = {"embed": body.embed_tokens.weight.to(dt), "norm": body.norm.weight.to(dt),
              "layers": layers}
        return _detached({"encoder": enc, "projector": proj, "lm": lm})

    def encode_inference(self, prepared: Dict, images: torch.Tensor) -> Tuple[torch.Tensor]:
        """Preprocessed float NHWC images -> (A_flat [B, K, C],), the trunk
        map in the compute dtype (slot = h * W + w)."""
        A = resnet_apply_folded(prepared["encoder"], images.to(self.compute_dtype), self.arch)
        B, Hf, Wf, C = A.shape
        return (A.reshape(B, Hf * Wf, C),)

    def image_tokens(self, prepared: Dict, A_flat: torch.Tensor) -> torch.Tensor:
        """The projector: [B, K, C] -> [B, K, hidden] (exact GELU)."""
        (w0, b0), (w1, b1) = prepared["projector"]
        return F.linear(F.gelu(F.linear(A_flat, w0, b0)), w1, b1)

    # ------------------------------------------------------------ the LM
    def _mamba_prefill(self, p: Dict, x: torch.Tensor, cache: HybridCache, i: int):
        s = self.lm
        proj = F.linear(x, p["in_proj"])
        z, xbc, dt = proj.split([s.d_inner, s.conv_dim, s.m_heads], dim=-1)
        xbc, cache.conv[i] = ssd.causal_conv(xbc, p["conv_w"], p["conv_b"])
        xs, Bm, Cm = xbc.split([s.d_inner, s.groups * s.d_state, s.groups * s.d_state], dim=-1)
        Bsz, L, _ = x.shape
        y, state = ssd.ssd_prefill(
            xs.reshape(Bsz, L, s.m_heads, s.m_head_dim), F.softplus(dt.float() + p["dt_bias"]),
            p["A"], Bm.reshape(Bsz, L, s.groups, s.d_state),
            Cm.reshape(Bsz, L, s.groups, s.d_state), p["D"], s.chunk)
        cache.ssm[i] = state
        y = gated_rms_norm(y.reshape(Bsz, L, s.d_inner), z, p["norm"], s.eps)
        return F.linear(y, p["out_proj"])

    def _mamba_step(self, p: Dict, x: torch.Tensor, cache: HybridCache, i: int):
        s = self.lm
        proj = F.linear(x, p["in_proj"])
        z, xbc, dt = proj.split([s.d_inner, s.conv_dim, s.m_heads], dim=-1)
        y = SS.ssm_step(xbc, dt, cache.conv[i], p["conv_w"], p["conv_b"], p["dt_bias"], p["A"],
                        p["D"], cache.ssm[i])
        return F.linear(gated_rms_norm(y, z, p["norm"], s.eps), p["out_proj"])

    def _attn(self, p: Dict, x: torch.Tensor, cache: HybridCache, i: int) -> torch.Tensor:
        """Attention of x's L positions at cache.pos.. (their keys and values
        written into the cache), over every filled position."""
        s = self.lm
        Bsz, L, _ = x.shape
        q, k, v = F.linear(x, p["qkv"]).split(
            [s.hidden, s.kv_heads * s.head_dim, s.kv_heads * s.head_dim], dim=-1)
        q = q.reshape(Bsz, L, s.kv_heads, s.heads // s.kv_heads, s.head_dim).permute(0, 2, 3, 1, 4)
        k = k.reshape(Bsz, L, s.kv_heads, s.head_dim).transpose(1, 2)
        v = v.reshape(Bsz, L, s.kv_heads, s.head_dim).transpose(1, 2)
        t0, t1 = cache.pos, cache.pos + L
        cache.k[i, :, :, t0:t1] = k
        cache.v[i, :, :, t0:t1] = v
        o = _attend(q, cache.k[i, :, :, :t1], cache.v[i, :, :, :t1], s.attn_scale,
                    causal=L > 1)
        return F.linear(o.permute(0, 3, 1, 2, 4).reshape(Bsz, L, s.hidden), p["o_proj"])

    def _layers(self, prepared: Dict, h: torch.Tensor, cache: HybridCache, prefill: bool):
        s = self.lm
        r = s.residual_mult
        for (kind, i), p in zip(s.slots(), prepared["lm"]["layers"]):
            x = rms_norm(h, p["norm_in"], s.eps)
            if kind == "attention":
                out = self._attn(p, x, cache, i)
            elif prefill:
                out = self._mamba_prefill(p, x, cache, i)
            else:
                out = self._mamba_step(p, x[:, 0], cache, i)[:, None]
            h = torch.add(h, out, alpha=r)  # h + r * out, one rounding
            h = torch.add(h, _mlp(p, rms_norm(h, p["norm_mlp"], s.eps)), alpha=r)
        cache.pos += h.shape[1]
        return h

    @torch.no_grad()
    def prefill(self, prepared: Dict, A_flat: torch.Tensor, new_tokens: int) -> HybridCache:
        """The cache of a batch, allocated for its image tokens and
        new_tokens more, filled by the prefill of the image tokens
        (projector(A_flat) * embedding_multiplier)."""
        s = self.lm
        Bsz, K, _ = A_flat.shape
        cache = HybridCache(s, Bsz, K + new_tokens, self.compute_dtype, A_flat.device)
        h = self.image_tokens(prepared, A_flat) * s.embed_mult
        self._layers(prepared, h, cache, prefill=True)
        return cache

    @torch.no_grad()
    def step(self, prepared: Dict, tokens: torch.Tensor, cache: HybridCache) -> torch.Tensor:
        """One decode step: tokens [B] at position cache.pos -> the logits
        [B, vocab] in the compute dtype; the cache advances."""
        s = self.lm
        lm = prepared["lm"]
        h = F.embedding(tokens.long(), lm["embed"])[:, None] * s.embed_mult
        h = self._layers(prepared, h, cache, prefill=False)
        return F.linear(rms_norm(h[:, 0], lm["norm"], s.eps), lm["embed"]) / s.logits_scaling

    @torch.no_grad()
    def greedy_ids(self, prepared: Dict, A_flat: torch.Tensor, steps: int, start: int, eos: int,
                   early_exit: bool = False) -> torch.Tensor:
        """decoding/greedy.py's loop for this model: the prefill under the
        span ``decode.prefill``, then `steps` steps from `start`, each
        taking the argmax of the logits; a row that has written `eos`
        writes it on. Returns ids [B, steps] (int32). early_exit: stop
        once every row has ended (the rest `eos`)."""
        with span("decode.prefill"):
            cache = self.prefill(prepared, A_flat, steps)
        B = A_flat.shape[0]
        tok = torch.full((B,), start, dtype=torch.int32, device=A_flat.device)
        finished = torch.zeros((B,), dtype=torch.bool, device=A_flat.device)
        ids = []
        for _ in range(steps):
            nxt = self.step(prepared, tok, cache).argmax(-1).int()
            nxt = torch.where(finished, torch.full_like(nxt, eos), nxt)
            finished = finished | (nxt == eos)
            ids.append(nxt)
            tok = nxt
            if early_exit and bool(finished.all()):
                break
        ids += [torch.full_like(ids[-1], eos)] * (steps - len(ids))
        return torch.stack(ids, 1)


def build_hybrid(cf, device: torch.device, dtype) -> HybridModel:
    return HybridModel(variant=cf.atten_model_name, arch=cf.encoder_backbone, lm=lm_spec(cf),
                       compute_dtype=dtype, device=device)

