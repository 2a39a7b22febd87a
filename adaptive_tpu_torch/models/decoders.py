"""Caption decoders: baseline / adaptive (visual sentinel) / rnn attention
(counterpart of adaptive_tpu/models/decoders.py).

``Decoder`` carries the reference's module names (embed, LSTM, adaptive.
{atten, mlp}; the adaptive variant's adaptive.sentinel, rnn's
adaptive.atten.lstm), so its state_dict keys are the reference
checkpoint's ``decoder.*`` keys. The decode functions take the parameters in
the JAX layout (``decoder_params``): linear kernels [in, out], LSTM weights
[in, 4H] with gate order i,f,g,o, applied as ``x @ W``.

The variants differ in what joins h in the vocab head, scores = mlp(a + h):
baseline a = c, the spatial context (baseline_attention.py:100-194);
adaptive a = c_hat, the sentinel's mix (adaptive_attention.py:89-155); rnn
a = F_T, the LSTM aggregate of the sigmoid-gated slots (rnn_attention.py:
70-83). Only the adaptive variant has a fused cell kernel; the other two
run their cell op by op, and on the fused path their head goes through the
same head kernels (a in the c_hat slot), which JAX leaves to XLA's logits.

The sentinel's h_{t-1} is ZERO at every decode step unless
sampler_sentinel_uses_prev_hidden is set: the reference's sampler calls the
decoder one token at a time, and its zero-prefixed shift always yields zero.
Teacher forcing (``decoder_forward``, the train path) shifts the hiddens with
a zero prefix, as the reference does (adaptive_attention.py:116-122).

Tensor parallelism (decoding/spmd.py): with ``tp_group`` the embedding rows
and, with ``head_tp``, the prepared head's columns are this rank's slice of
the model group's; ``embed_lookup`` assembles each row with an all-reduce
(one shard owns a token), and the head runs the top-W kernel on the shard
and merges the shards' lists with the kernel's own tie rule
(``_tp_merge_topk``), so the ids equal one process's.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from adaptive_tpu_torch.ops import attention as att
from adaptive_tpu_torch.ops import fused_step as fs
from adaptive_tpu_torch.ops import inits
from adaptive_tpu_torch.ops.dropout import Drop, maybe_drop as _d
from adaptive_tpu_torch.ops.lstm import lstm_cell, lstm_scan
from adaptive_tpu_torch.parallel.mesh import gather

# the attention's affines of each variant, under adaptive.atten
ATTEN_AFFINES = {
    "baseline_attention": ("affine_v", "affine_g", "affine_h"),
    "adaptive_attention": ("affine_v", "affine_g", "affine_s", "affine_h"),
    "rnn_attention": ("affine_v", "affine_g", "affine_h"),
}
SENTINEL_AFFINES = ("affine_x", "affine_h")


class DecoderSpec(NamedTuple):
    variant: str  # baseline_attention | adaptive_attention | rnn_attention
    embed_size: int
    hidden_size: int
    vocab_size: int
    num_slots: int = 49
    atten_dim: int = 49
    rnn_bidirectional: bool = True
    rnn_num_layers: int = 1
    # vocab dim of the embedding/head params; > vocab_size when padded
    padded_vocab: int = 0

    @property
    def vocab_param_dim(self) -> int:
        return self.padded_vocab or self.vocab_size


def _linear(cin, cout, bias=False):
    return nn.Linear(cin, cout, bias=bias)


def _copy_lstm(gen, lstm: nn.LSTM, suffix: str = "") -> None:
    """The JAX package's lstm_init into one direction of an nn.LSTM."""
    w = inits.lstm_init(gen, lstm.input_size, lstm.hidden_size, lstm.weight_ih_l0.device)
    for jk, tk in (("w_ih", "weight_ih_l0"), ("w_hh", "weight_hh_l0"),
                   ("b_ih", "bias_ih_l0"), ("b_hh", "bias_hh_l0")):
        getattr(lstm, tk + suffix).copy_(w[jk])


class Decoder(nn.Module):
    """Reference Decoder + AdaptiveBlock (+ Sentinel) + Atten parameters of
    spec.variant."""

    def __init__(self, spec: DecoderSpec):
        super().__init__()
        if spec.variant not in ATTEN_AFFINES:
            raise ValueError(f"unknown variant {spec.variant}")
        self.spec = spec
        E, H, D, Vp = spec.embed_size, spec.hidden_size, spec.atten_dim, spec.vocab_param_dim
        self.embed = nn.Embedding(Vp, E)
        self.LSTM = nn.LSTM(2 * E, H, 1, batch_first=True)
        self.adaptive = nn.Module()
        if spec.variant == "adaptive_attention":
            self.adaptive.sentinel = nn.Module()
            self.adaptive.sentinel.affine_x = _linear(2 * E, H)
            self.adaptive.sentinel.affine_h = _linear(H, H)
        self.adaptive.atten = nn.Module()
        for name in ATTEN_AFFINES[spec.variant]:
            setattr(self.adaptive.atten, name, _linear(D, 1) if name == "affine_h" else
                    _linear(H, D))
        if spec.variant == "rnn_attention":
            bi = spec.rnn_bidirectional
            self.adaptive.atten.lstm = nn.LSTM(H, H // 2 if bi else H, 1, batch_first=True,
                                               bidirectional=bi)
        self.adaptive.mlp = _linear(H, Vp, bias=True)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        """The JAX package's init (decoders.py:65-111): embed N(0,1); LSTMs
        orthogonal with forget bias 0.5 in each bias; atten v/g
        xavier_normal(tanh) (baseline) or xavier_uniform(tanh), with s
        (adaptive); atten h kaiming_normal(relu), or xavier_uniform(sigmoid)
        for rnn; sentinel xavier_uniform(sigmoid); mlp kaiming_normal(relu)
        with zero bias."""
        variant = self.spec.variant
        dev = self.embed.weight.device
        self.embed.weight.normal_(0.0, 1.0, generator=gen)
        _copy_lstm(gen, self.LSTM)
        atten = self.adaptive.atten
        vg = "xavier_normal" if variant == "baseline_attention" else "xavier_uniform"
        schemes = [(getattr(atten, n), vg, "tanh") for n in ATTEN_AFFINES[variant][:-1]]
        schemes.append((atten.affine_h, "xavier_uniform", "sigmoid") if variant == "rnn_attention"
                       else (atten.affine_h, "kaiming_normal", "relu"))
        if variant == "adaptive_attention":
            schemes += [(getattr(self.adaptive.sentinel, n), "xavier_uniform", "sigmoid")
                        for n in SENTINEL_AFFINES]
        schemes.append((self.adaptive.mlp, "kaiming_normal", "relu"))
        for lin, scheme, nl in schemes:
            lin.weight.copy_(inits.linear_weight(
                gen, lin.in_features, lin.out_features, scheme, nl, dev))
        self.adaptive.mlp.bias.zero_()
        if variant == "rnn_attention":
            _copy_lstm(gen, atten.lstm)
            if atten.lstm.bidirectional:
                _copy_lstm(gen, atten.lstm, "_reverse")


def _lstm_params(lstm: nn.LSTM, t, v, suffix: str = "") -> Dict:
    return {"w_ih": t(getattr(lstm, "weight_ih_l0" + suffix)),
            "w_hh": t(getattr(lstm, "weight_hh_l0" + suffix)),
            "b_ih": v(getattr(lstm, "bias_ih_l0" + suffix)),
            "b_hh": v(getattr(lstm, "bias_hh_l0" + suffix))}


def decoder_params(dec: Decoder, detach: bool = True) -> Dict:
    """The decoder's parameters in the JAX layout (kernels [in, out]), the
    tree of its variant (JAX's init_decoder): as the decode functions take
    them, contiguous copies outside autograd; or with detach=False, as
    decoder_forward's train path takes them, views that carry gradients to
    the weights."""
    v = (lambda w: w.detach()) if detach else (lambda w: w)  # noqa: E731
    t = (lambda w: w.detach().T.contiguous()) if detach else (lambda w: w.T)  # noqa: E731
    variant = dec.spec.variant
    a = dec.adaptive
    atten = {n: {"kernel": t(getattr(a.atten, n).weight)} for n in ATTEN_AFFINES[variant]}
    block = {"atten": atten, "mlp": {"kernel": t(a.mlp.weight), "bias": v(a.mlp.bias)}}
    if variant == "adaptive_attention":
        block["sentinel"] = {n: {"kernel": t(getattr(a.sentinel, n).weight)}
                             for n in SENTINEL_AFFINES}
    if variant == "rnn_attention":
        atten["lstm_fwd"] = _lstm_params(a.atten.lstm, t, v)
        if a.atten.lstm.bidirectional:
            atten["lstm_bwd"] = _lstm_params(a.atten.lstm, t, v, "_reverse")
    return {"embed": v(dec.embed.weight), "lstm": _lstm_params(dec.LSTM, t, v),
            "adaptive": block}


def mask_padded_vocab(spec: DecoderSpec, scores: torch.Tensor) -> torch.Tensor:
    """Set logits of vocab-padding columns to the dtype's lowest value, so
    softmax/argmax equal the unpadded model's."""
    if not spec.padded_vocab or spec.padded_vocab == spec.vocab_size:
        return scores
    col = torch.arange(scores.shape[-1], device=scores.device)
    low = torch.finfo(scores.dtype).min
    return torch.where(col < spec.vocab_size, scores, torch.full_like(scores, low))


def attend(
    block: Dict, spec: DecoderSpec, x: torch.Tensor, hiddens: torch.Tensor,
    cells: torch.Tensor, V: torch.Tensor, h_prev: Optional[torch.Tensor] = None,
    pv: Optional[torch.Tensor] = None, drop: Drop = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(a [B,T,H], alpha [B,T,K], beta [B,T,1] or None): what joins the
    hiddens in the vocab head, a = c (baseline), c_hat (adaptive) or F_T
    (rnn), the attention maps and the adaptive variant's sentinel share.
    x and cells are read by the adaptive sentinel only; h_prev is its
    previous hiddens [B,T,H], None the reference's zero-prefixed shift of
    hiddens."""
    if spec.variant == "baseline_attention":
        c, alpha = att.spatial_attention(block["atten"], V, hiddens, pv, drop)
        return c, alpha, None
    if spec.variant == "rnn_attention":
        f, alpha = att.recurrent_attention(block["atten"], V, hiddens, spec.rnn_bidirectional,
                                           pv, drop)
        return f, alpha, None
    if h_prev is None:
        h_prev = torch.cat([torch.zeros_like(hiddens[:, :1]), hiddens[:, :-1]], dim=1)
    s = att.sentinel_gate(block["sentinel"], x, h_prev, cells, drop)
    return att.adaptive_attention(block["atten"], V, hiddens, s, pv, drop)


def adaptive_block_apply(
    block: Dict, spec: DecoderSpec, x: torch.Tensor, hiddens: torch.Tensor,
    cells: torch.Tensor, V: torch.Tensor, h_prev: Optional[torch.Tensor] = None,
    pv: Optional[torch.Tensor] = None, drop: Drop = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(scores [B,T,vocab], alpha [B,T,K], beta [B,T,1], None but for the
    adaptive variant) of the block over all T steps: scores = mlp(a +
    hiddens) with attend's a. drop: train-time dropout at every affine
    input, the vocab mlp's too (adaptive_attention.py:132)."""
    a, alpha, beta = attend(block, spec, x, hiddens, cells, V, h_prev, pv, drop)
    return inits.linear(block["mlp"], _d(drop, a + hiddens)), alpha, beta


def decoder_forward(
    params: Dict, spec: DecoderSpec, V: torch.Tensor, v_g: torch.Tensor,
    captions: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor, drop: Drop = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Teacher-forced scores for every step (Decoder.forward,
    baseline_attention.py:148-194): captions [B,T] int -> (scores
    [B,T,vocab], alpha, beta; beta None but for the adaptive variant)."""
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
    """The adaptive variant's fused cell kernel: (h', c', c_hat, alpha,
    beta). beam_w > 1: V/pv arrive untiled, one row per image, and the
    kernel shares each image's slots across its beam_w batch-major beam rows
    (beam-major layout). cell_t: the prepared fs.CellTiles
    (prepare_cell_tiles), or None."""
    block = params["adaptive"]
    hp = state.h_prev if sentinel_uses_prev_hidden else torch.zeros_like(state.h)
    if pv is None:
        pv = V @ block["atten"]["affine_v"]["kernel"]
    return fs.adaptive_decode_cell_fused(
        params["lstm"], block["atten"], block["sentinel"], x, state.h, state.c, hp, V, pv,
        beam_w=beam_w, cell_t=cell_t,
    )


def _plain_cell(params, spec: DecoderSpec, x, state: DecodeState, sentinel_uses_prev_hidden,
                V, pv=None):
    """One step's cell op by op, any variant: (h', c', a, alpha [B,K], beta
    [B,1]) with attend's a [B,H]; beta is zeros in a's dtype where the
    variant has none (decoders.py:230-231)."""
    h_new, (_, c) = lstm_cell(params["lstm"], x, (state.h, state.c))
    h_prev = state.h_prev if sentinel_uses_prev_hidden else torch.zeros_like(h_new)
    a, alpha, beta = attend(params["adaptive"], spec, x[:, None], h_new[:, None], c[:, None], V,
                            h_prev[:, None], pv)
    if beta is None:
        beta = a.new_zeros((a.shape[0], 1, 1))
    return h_new, c, a[:, 0], alpha[:, 0], beta[:, 0]


def _cell(params, spec, x, state, sentinel_uses_prev_hidden, V, pv, fused, beam_w=1, cell_t=None):
    """The step's cell: the fused kernel for the adaptive variant on the
    fused path, else _plain_cell, which reads one row of slots per row
    (V/pv repeated beam_w times)."""
    if fused and spec.variant == "adaptive_attention":
        return _fused_cell(params, x, state, sentinel_uses_prev_hidden, V, pv, beam_w, cell_t)
    V, pv = _per_row(V, pv, beam_w)
    return _plain_cell(params, spec, x, state, sentinel_uses_prev_hidden, V, pv)


def _per_row(V, pv, beam_w: int):
    """V/pv of one row per image -> one row per beam row (batch-major)."""
    if beam_w == 1:
        return V, pv
    return V.repeat_interleave(beam_w, 0), None if pv is None else pv.repeat_interleave(beam_w, 0)


@torch.no_grad()
def decode_step(
    params: Dict, spec: DecoderSpec, token: torch.Tensor, v_g: torch.Tensor,
    state: DecodeState, V: torch.Tensor, sentinel_uses_prev_hidden: bool = False,
    pv: Optional[torch.Tensor] = None, fused: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, DecodeState]:
    """token [B] -> (logits [B,vocab], alpha [B,K], beta [B,1], state').
    fused routes the adaptive variant's cell through the fused kernel; the
    head stays a matmul."""
    x = torch.cat([params["embed"][token], v_g], dim=-1)  # [B, 2E]
    h_new, c_new, a, alpha, beta = _cell(params, spec, x, state, sentinel_uses_prev_hidden, V, pv,
                                         fused)
    logits = inits.linear(params["adaptive"]["mlp"], a + h_new)
    return mask_padded_vocab(spec, logits), alpha, beta, DecodeState(h_new, c_new, h_new)


def embed_lookup(table: torch.Tensor, token: torch.Tensor, tp_group=None) -> torch.Tensor:
    """Embedding rows of token [B], tensor-parallel-aware: with tp_group the
    table is this rank's slice of rows [rank * vloc, (rank + 1) * vloc); each
    rank contributes its in-range rows (zeros elsewhere) and an all-reduce
    sums them, exact since one shard owns each token. A whole table on every
    rank gives the same rows: rank 0's range covers the vocab, the others'
    none."""
    if tp_group is None:
        return table[token]
    vloc = table.shape[0]
    rel = token.long() - dist.get_rank(tp_group) * vloc
    ok = (rel >= 0) & (rel < vloc)
    emb = torch.where(ok[:, None], table[rel.clamp(0, vloc - 1)], torch.zeros((), dtype=table.dtype,
                                                                              device=table.device))
    dist.all_reduce(emb, group=tp_group)
    return emb


def merge_topk(allv: torch.Tensor, alli: torch.Tensor, k: int):
    """The top-k (values [R, k], ids [R, k] int32) of the shards' lists laid
    side by side (allv, alli [R, S*k], global ids): k passes of the largest
    value, ties to the lower id, the taken id masked to -1e30; the rule of
    the head kernels' chunk merge, so the result equals one kernel's list."""
    big = torch.full((), 2 ** 30, dtype=alli.dtype, device=alli.device)
    neg = torch.full((), fs.NEG, dtype=allv.dtype, device=allv.device)
    vs, ids = [], []
    for _ in range(k):
        v = allv.max(dim=1, keepdim=True).values
        i = torch.where(allv == v, alli, big).min(dim=1, keepdim=True).values
        vs.append(v)
        ids.append(i)
        allv = torch.where(alli == i, neg, allv)
    return torch.cat(vs, 1), torch.cat(ids, 1)


def _tp_merge_topk(topv, topi, k: int, tp_group):
    """The global top-k of the model group's per-shard lists (global ids):
    an all-gather over the group, then merge_topk."""
    return merge_topk(gather(topv, tp_group, 1), gather(topi, tp_group, 1), k)


def _shard_topk(head, c_hat, h_new, k: int, tp_group):
    """The column-sharded head: kernel 4 on this rank's columns with every
    column live (the -1e30 bias pad masks), its ids moved to global ids,
    merged over the group. Returns (topv, topi, the shard's lse [R, 1])."""
    vloc = head[0].shape[1]
    topv, topi, lse = fs.beam_head_topk(*head, c_hat, h_new, vloc, k,
                                        head_kernel_t=head.kernel_t)
    topi = topi + dist.get_rank(tp_group) * vloc
    topv, topi = _tp_merge_topk(topv, topi, k, tp_group)
    return topv, topi, lse


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
    """The adaptive variant's cell weights reordered for its tensor-core
    instance (fs.cell_kernel_tiles), made once per checkpoint where
    fs.cell_instance picks that instance (bfloat16, H and 2E multiples of
    64), else None."""
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
    tp_group=None, head_tp: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, DecodeState]:
    """One GREEDY step: token [B] -> (next_token [B] int32, alpha, beta, state').
    With fused and a prepared head, the head+argmax runs as one kernel call
    on the cell's a (c_hat, c or F_T), and the adaptive variant's cell as
    another (on the prepared cell_t where given; the other variants' cells
    run op by op); otherwise argmax over decode_step's logits. tp_group:
    the embedding is this rank's rows of the model group's (embed_lookup);
    head_tp: the head is its columns, and the argmax is kernel 4 at W = 1
    on them, merged over the group (_shard_topk)."""
    if fused and head is not None:
        x = torch.cat([embed_lookup(params["embed"], token, tp_group), v_g], dim=-1)
        h_new, c_new, c_hat, alpha, beta = _cell(
            params, spec, x, state, sentinel_uses_prev_hidden, V, pv, fused, cell_t=cell_t)
        if head_tp:
            nxt = _shard_topk(head, c_hat, h_new, 1, tp_group)[1][:, 0]
        else:
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
    cell_t=None, tp_group=None, head_tp: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, DecodeState]:
    """One BEAM step: token [R] -> (logp_top [R,k] fp32 log-probs, tok_top
    [R,k] int32, alpha, beta, state').

    Each row's top-k is enough: the global top-k over all beam x vocab
    candidates holds at most k continuations of one source beam. With fused
    and a prepared head, the head + top-k + logsumexp runs as one kernel
    call on the cell's a and the logits are never stored, the cell as in
    greedy_decode_step; otherwise top-k of the fp32 log_softmax of
    decode_step's logits. Ties rank the lower token id first either way (as
    lax.top_k).

    beam_w > 1: V/pv arrive untiled, one row per image, while token and
    state carry beam_w batch-major rows per image; the fused cell shares
    them, a plain cell repeats them per row. tp_group, head_tp: as
    greedy_decode_step's, and the row's logsumexp combines the shards'.
    """
    if fused and head is not None:
        x = torch.cat([embed_lookup(params["embed"], token, tp_group), v_g], dim=-1)
        h_new, c_new, c_hat, alpha, beta = _cell(
            params, spec, x, state, sentinel_uses_prev_hidden, V, pv, fused, beam_w, cell_t)
        if head_tp:
            # the shards' logsumexps cover disjoint columns: their combine is
            # the row's (to rounding)
            topv, topi, lse_l = _shard_topk(head, c_hat, h_new, k, tp_group)
            alls = gather(lse_l, tp_group, 1)
            m = alls.max(dim=1, keepdim=True).values
            lse = torch.log(torch.exp(alls - m).sum(dim=1, keepdim=True)) + m
        else:
            topv, topi, lse = fs.beam_head_topk(*head, c_hat, h_new, spec.vocab_size, k,
                                                head_kernel_t=head.kernel_t)
        return topv - lse, topi, alpha, beta, DecodeState(h_new, c_new, h_new)
    V, pv = _per_row(V, pv, beam_w)
    logits, alpha, beta, st = decode_step(
        params, spec, token, v_g, state, V, sentinel_uses_prev_hidden, pv=pv, fused=fused)
    logp = torch.log_softmax(logits.float(), dim=-1)
    topv, topi = fs.topk_lower_index_first(logp, k)
    return topv, topi.to(torch.int32), alpha, beta, st
