"""Caption decoder, adaptive-attention variant (counterpart of
adaptive_tpu/models/decoders.py).

``Decoder`` carries the reference's module names (embed, LSTM, adaptive.
{sentinel, atten, mlp}), so its state_dict keys are the reference
checkpoint's ``decoder.*`` keys. The decode functions take the parameters in
the JAX layout (``decoder_params``): linear kernels [in, out], LSTM weights
[in, 4H] with gate order i,f,g,o, applied as ``x @ W``.

The sentinel's h_{t-1} is ZERO at every decode step unless
sampler_sentinel_uses_prev_hidden is set: the reference's sampler calls the
decoder one token at a time, and its zero-prefixed shift always yields zero.
Teacher forcing (``decoder_forward``, the train path) shifts the hiddens with
a zero prefix, as the reference does (adaptive_attention.py:116-122).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from adaptive_tpu_torch.ops import attention as att
from adaptive_tpu_torch.ops import fused_step as fs
from adaptive_tpu_torch.ops import inits
from adaptive_tpu_torch.ops.dropout import Drop, maybe_drop as _d
from adaptive_tpu_torch.ops.lstm import lstm_cell, lstm_scan

NOT_PORTED = "{} is not ported yet: ROADMAP.md, queue 1 (non-adaptive decoder variants)"


class DecoderSpec(NamedTuple):
    variant: str  # only adaptive_attention is ported
    embed_size: int
    hidden_size: int
    vocab_size: int
    num_slots: int = 49
    atten_dim: int = 49
    # vocab dim of the embedding/head params; > vocab_size when padded
    padded_vocab: int = 0

    @property
    def vocab_param_dim(self) -> int:
        return self.padded_vocab or self.vocab_size


def _linear(cin, cout, bias=False):
    return nn.Linear(cin, cout, bias=bias)


class Decoder(nn.Module):
    """Reference Decoder + AdaptiveBlock + Sentinel + Atten parameters."""

    def __init__(self, spec: DecoderSpec):
        super().__init__()
        if spec.variant != "adaptive_attention":
            raise NotImplementedError(NOT_PORTED.format(spec.variant))
        E, H, D, Vp = spec.embed_size, spec.hidden_size, spec.atten_dim, spec.vocab_param_dim
        self.embed = nn.Embedding(Vp, E)
        self.LSTM = nn.LSTM(2 * E, H, 1, batch_first=True)
        self.adaptive = nn.Module()
        self.adaptive.sentinel = nn.Module()
        self.adaptive.sentinel.affine_x = _linear(2 * E, H)
        self.adaptive.sentinel.affine_h = _linear(H, H)
        self.adaptive.atten = nn.Module()
        for name in ("affine_v", "affine_g", "affine_s"):
            setattr(self.adaptive.atten, name, _linear(H, D))
        self.adaptive.atten.affine_h = _linear(D, 1)
        self.adaptive.mlp = _linear(H, Vp, bias=True)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        """The JAX package's init: embed N(0,1); LSTM orthogonal with forget
        bias 0.5 in each bias; atten v/g/s xavier_uniform(tanh), h
        kaiming_normal(relu); sentinel xavier_uniform(sigmoid); mlp
        kaiming_normal(relu) with zero bias."""
        dev = self.embed.weight.device
        self.embed.weight.normal_(0.0, 1.0, generator=gen)
        E2, H = self.LSTM.input_size, self.LSTM.hidden_size
        lstm = inits.lstm_init(gen, E2, H, dev)
        self.LSTM.weight_ih_l0.copy_(lstm["w_ih"])
        self.LSTM.weight_hh_l0.copy_(lstm["w_hh"])
        self.LSTM.bias_ih_l0.copy_(lstm["b_ih"])
        self.LSTM.bias_hh_l0.copy_(lstm["b_hh"])
        schemes = [
            (self.adaptive.atten.affine_v, "xavier_uniform", "tanh"),
            (self.adaptive.atten.affine_g, "xavier_uniform", "tanh"),
            (self.adaptive.atten.affine_s, "xavier_uniform", "tanh"),
            (self.adaptive.atten.affine_h, "kaiming_normal", "relu"),
            (self.adaptive.sentinel.affine_x, "xavier_uniform", "sigmoid"),
            (self.adaptive.sentinel.affine_h, "xavier_uniform", "sigmoid"),
            (self.adaptive.mlp, "kaiming_normal", "relu"),
        ]
        for lin, scheme, nl in schemes:
            lin.weight.copy_(inits.linear_weight(
                gen, lin.in_features, lin.out_features, scheme, nl, dev))
        self.adaptive.mlp.bias.zero_()


def decoder_params(dec: Decoder, detach: bool = True) -> Dict:
    """The decoder's parameters in the JAX layout (kernels [in, out]): as
    the decode functions take them, contiguous copies outside autograd; or
    with detach=False, as decoder_forward's train path takes them, views
    that carry gradients to the weights."""
    v = (lambda w: w.detach()) if detach else (lambda w: w)  # noqa: E731
    t = (lambda w: w.detach().T.contiguous()) if detach else (lambda w: w.T)  # noqa: E731
    a = dec.adaptive
    return {
        "embed": v(dec.embed.weight),
        "lstm": {"w_ih": t(dec.LSTM.weight_ih_l0), "w_hh": t(dec.LSTM.weight_hh_l0),
                 "b_ih": v(dec.LSTM.bias_ih_l0), "b_hh": v(dec.LSTM.bias_hh_l0)},
        "adaptive": {
            "atten": {n: {"kernel": t(getattr(a.atten, n).weight)}
                      for n in ("affine_v", "affine_g", "affine_s", "affine_h")},
            "sentinel": {n: {"kernel": t(getattr(a.sentinel, n).weight)}
                         for n in ("affine_x", "affine_h")},
            "mlp": {"kernel": t(a.mlp.weight), "bias": v(a.mlp.bias)},
        },
    }


def mask_padded_vocab(spec: DecoderSpec, scores: torch.Tensor) -> torch.Tensor:
    """Set logits of vocab-padding columns to the dtype's lowest value, so
    softmax/argmax equal the unpadded model's."""
    if not spec.padded_vocab or spec.padded_vocab == spec.vocab_size:
        return scores
    col = torch.arange(scores.shape[-1], device=scores.device)
    low = torch.finfo(scores.dtype).min
    return torch.where(col < spec.vocab_size, scores, torch.full_like(scores, low))


def adaptive_block_apply(
    block: Dict, spec: DecoderSpec, x: torch.Tensor, hiddens: torch.Tensor,
    cells: torch.Tensor, V: torch.Tensor, h_prev: Optional[torch.Tensor] = None,
    pv: Optional[torch.Tensor] = None, drop: Drop = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(scores [B,T,vocab], alpha [B,T,K], beta [B,T,1]) of the adaptive
    block over all T steps. h_prev: the sentinel's previous hiddens [B,T,H];
    None is the reference's zero-prefixed shift of hiddens. drop: train-time
    dropout at every affine input, the vocab mlp's too
    (adaptive_attention.py:132)."""
    if spec.variant != "adaptive_attention":
        raise NotImplementedError(NOT_PORTED.format(spec.variant))
    if h_prev is None:
        h_prev = torch.cat([torch.zeros_like(hiddens[:, :1]), hiddens[:, :-1]], dim=1)
    s = att.sentinel_gate(block["sentinel"], x, h_prev, cells, drop)
    c_hat, alpha, beta = att.adaptive_attention(block["atten"], V, hiddens, s, pv, drop)
    scores = inits.linear(block["mlp"], _d(drop, c_hat + hiddens))
    return scores, alpha, beta


def decoder_forward(
    params: Dict, spec: DecoderSpec, V: torch.Tensor, v_g: torch.Tensor,
    captions: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor, drop: Drop = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Teacher-forced scores for every step (Decoder.forward,
    baseline_attention.py:148-194): captions [B,T] int -> (scores
    [B,T,vocab], alpha, beta)."""
    emb = params["embed"][captions]  # [B,T,E]
    x = torch.cat([emb, v_g[:, None, :].expand_as(emb)], dim=-1)
    hiddens, cells, _ = lstm_scan(params["lstm"], x, (h0, c0))
    scores, alpha, beta = adaptive_block_apply(
        params["adaptive"], spec, x, hiddens, cells, V, drop=drop)
    return mask_padded_vocab(spec, scores), alpha, beta


class DecodeState(NamedTuple):
    h: torch.Tensor  # [B,H] LSTM hidden
    c: torch.Tensor  # [B,H] LSTM cell
    h_prev: torch.Tensor  # [B,H] the sentinel's h_{t-1}: previous output, zero at step 0


def _fused_cell(params, x, state: DecodeState, sentinel_uses_prev_hidden, V, pv, beam_w=1,
                cell_t=None):
    """The fused cell kernel. beam_w > 1: V/pv arrive untiled, one row per
    image, and the kernel shares each image's slots across its beam_w
    batch-major beam rows (beam-major layout). cell_t: the prepared
    fs.CellTiles (prepare_cell_tiles), or None."""
    block = params["adaptive"]
    hp = state.h_prev if sentinel_uses_prev_hidden else torch.zeros_like(state.h)
    if pv is None:
        pv = V @ block["atten"]["affine_v"]["kernel"]
    return fs.adaptive_decode_cell_fused(
        params["lstm"], block["atten"], block["sentinel"], x, state.h, state.c, hp, V, pv,
        beam_w=beam_w, cell_t=cell_t,
    )


@torch.no_grad()
def decode_step(
    params: Dict, spec: DecoderSpec, token: torch.Tensor, v_g: torch.Tensor,
    state: DecodeState, V: torch.Tensor, sentinel_uses_prev_hidden: bool = False,
    pv: Optional[torch.Tensor] = None, fused: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, DecodeState]:
    """token [B] -> (logits [B,vocab], alpha [B,K], beta [B,1], state').
    fused routes the cell through the fused kernel; the head stays a matmul."""
    x = torch.cat([params["embed"][token], v_g], dim=-1)  # [B, 2E]
    if fused:
        h_new, c_new, c_hat, alpha, beta = _fused_cell(
            params, x, state, sentinel_uses_prev_hidden, V, pv)
        logits = inits.linear(params["adaptive"]["mlp"], c_hat + h_new)
        return mask_padded_vocab(spec, logits), alpha, beta, DecodeState(h_new, c_new, h_new)

    h_new, (h, c) = lstm_cell(params["lstm"], x, (state.h, state.c))
    h_prev = state.h_prev if sentinel_uses_prev_hidden else torch.zeros_like(h_new)
    block = params["adaptive"]
    s = att.sentinel_gate(block["sentinel"], x[:, None], h_prev[:, None], c[:, None])
    c_hat, alpha, beta = att.adaptive_attention(block["atten"], V, h_new[:, None], s, pv)
    logits = inits.linear(block["mlp"], c_hat + h_new[:, None])
    logits = mask_padded_vocab(spec, logits)
    return logits[:, 0], alpha[:, 0], beta[:, 0], DecodeState(h, c, h_new)


def prepare_greedy_head(params: Dict, spec: DecoderSpec):
    """Padded vocab head (kernel [H, Vp'], bias [Vp']) for the fused head
    kernels, made once per checkpoint: Vp' is a multiple of 128, and of 1280
    past 1280, as in the JAX package; every bias column past the real vocab
    is -1e30, so padded columns never win. The pair comes as a
    fs.PreparedHead, whose kernel_t is the kernel once more, transposed and
    tiled (fs.head_kernel_tiles), where the heads' tensor-core instance will
    read it (bfloat16, H a multiple of 8 up to 512), else None."""
    w = params["adaptive"]["mlp"]["kernel"]
    b = params["adaptive"]["mlp"]["bias"]
    vp = w.shape[1]
    target = -(-vp // 128) * 128
    if target > 1280:
        target = -(-target // 1280) * 1280
    w_p = torch.nn.functional.pad(w, (0, target - vp)).contiguous()
    b_p = torch.nn.functional.pad(b, (0, target - vp))
    col = torch.arange(target, device=b.device)
    b_p = torch.where(col < spec.vocab_size, b_p, torch.full_like(b_p, fs.NEG))
    w_t = fs.head_kernel_tiles(w_p) if fs.head_instance(w_p.dtype, w_p.shape[0]) == "mma" else None
    return fs.PreparedHead(w_p, b_p, w_t)


def prepare_cell_tiles(params: Dict):
    """The cell's weights reordered for its tensor-core instance
    (fs.cell_kernel_tiles), made once per checkpoint where fs.cell_instance
    picks that instance (bfloat16, H and 2E multiples of 64), else None."""
    whh, _, wx, whs, wg, ws, _ = fs.cell_operands(
        params["lstm"], params["adaptive"]["atten"], params["adaptive"]["sentinel"])
    if fs.cell_instance(whh.dtype, whh.shape[0], wx.shape[0]) != "mma":
        return None
    return fs.cell_kernel_tiles(whh, wx, whs, wg, ws)


@torch.no_grad()
def greedy_decode_step(
    params: Dict, spec: DecoderSpec, token: torch.Tensor, v_g: torch.Tensor,
    state: DecodeState, V: torch.Tensor, sentinel_uses_prev_hidden: bool = False,
    pv: Optional[torch.Tensor] = None, head=None, fused: bool = False, cell_t=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, DecodeState]:
    """One GREEDY step: token [B] -> (next_token [B] int32, alpha, beta, state').
    With fused and a prepared head, the cell and the head+argmax each run as
    one kernel call (the cell on the prepared cell_t where given); otherwise
    argmax over decode_step's logits."""
    if fused and head is not None:
        x = torch.cat([params["embed"][token], v_g], dim=-1)
        h_new, c_new, c_hat, alpha, beta = _fused_cell(
            params, x, state, sentinel_uses_prev_hidden, V, pv, cell_t=cell_t)
        nxt = fs.greedy_head_argmax(*head, c_hat, h_new, spec.vocab_size,
                                    head_kernel_t=head.kernel_t)
        return nxt, alpha, beta, DecodeState(h_new, c_new, h_new)
    logits, alpha, beta, st = decode_step(
        params, spec, token, v_g, state, V, sentinel_uses_prev_hidden, pv=pv, fused=fused)
    return torch.argmax(logits, dim=-1).to(torch.int32), alpha, beta, st


@torch.no_grad()
def beam_decode_step(
    params: Dict, spec: DecoderSpec, token: torch.Tensor, v_g: torch.Tensor,
    state: DecodeState, V: torch.Tensor, k: int, sentinel_uses_prev_hidden: bool = False,
    pv: Optional[torch.Tensor] = None, head=None, fused: bool = False, beam_w: int = 1,
    cell_t=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, DecodeState]:
    """One BEAM step: token [R] -> (logp_top [R,k] fp32 log-probs, tok_top
    [R,k] int32, alpha, beta, state').

    Each row's top-k is enough: the global top-k over all beam x vocab
    candidates holds at most k continuations of one source beam. With fused
    and a prepared head, the cell and the head + top-k + logsumexp each run
    as one kernel call (the cell on the prepared cell_t where given) and the
    logits are never stored; otherwise top-k of the
    fp32 log_softmax of decode_step's logits. Ties rank the lower token id
    first either way (as lax.top_k).

    beam_w > 1: V/pv arrive untiled, one row per image, while token and
    state carry beam_w batch-major rows per image; the plain path repeats
    them per row.
    """
    if fused and head is not None:
        x = torch.cat([params["embed"][token], v_g], dim=-1)
        h_new, c_new, c_hat, alpha, beta = _fused_cell(
            params, x, state, sentinel_uses_prev_hidden, V, pv, beam_w, cell_t)
        topv, topi, lse = fs.beam_head_topk(*head, c_hat, h_new, spec.vocab_size, k,
                                            head_kernel_t=head.kernel_t)
        return topv - lse, topi, alpha, beta, DecodeState(h_new, c_new, h_new)
    if beam_w > 1:
        V = V.repeat_interleave(beam_w, 0)
        pv = None if pv is None else pv.repeat_interleave(beam_w, 0)
    logits, alpha, beta, st = decode_step(
        params, spec, token, v_g, state, V, sentinel_uses_prev_hidden, pv=pv, fused=fused)
    logp = torch.log_softmax(logits.float(), dim=-1)
    topv, topi = fs.topk_lower_index_first(logp, k)
    return topv, topi.to(torch.int32), alpha, beta, st
