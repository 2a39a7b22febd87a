"""Batched beam search with <end> masking (counterpart of
adaptive_tpu/decoding/beam.py).

Each step scores all B*W beam rows with one decode step, expands the top W
over the W x W (beam, per-row top-W token) candidates of every image, and
freezes finished beams by forcing the <end> continuation at log-prob 0, so
their scores are final. Optional length normalisation: score / len^alpha
(Wu et al. 2016).

Histories are not reordered in the loop: each step records (token, parent
beam, raw alpha, raw beta), and one backward pass over the parent pointers
rebuilds every beam's path afterwards. The JAX package scans the step
inside one compiled program; here the step is a Python loop over eager
calls, two kernel launches a step on the fused path (ops/fused_step.py). In a
process group of more than one rank the fused decode runs over the config's
mesh, as the greedy decoder's does (decoding/spmd.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from adaptive_tpu_torch.decoding import spmd
from adaptive_tpu_torch.decoding.greedy import prepare_cached
from adaptive_tpu_torch.models.decoders import DecodeState
from adaptive_tpu_torch.models.factory import require_lstm
from adaptive_tpu_torch.ops.fused_step import topk_lower_index_first, tracing
from adaptive_tpu_torch.ops.preprocess import eval_preprocess

NEG_INF = -1e9  # a dead beam's score (the head kernels' mask is -1e30)


class BeamOutput(NamedTuple):
    ids: torch.Tensor  # [B, L] int32 best beam's tokens
    score: torch.Tensor  # [B] best beam's (normalised) log-prob
    all_ids: torch.Tensor  # [B, W, L] every beam
    all_scores: torch.Tensor  # [B, W]
    attention: torch.Tensor  # [B, L, K] best beam's spatial attention maps
    beta: torch.Tensor  # [B, L] best beam's sentinel share


def backtrack(hist):
    """Every beam's path from the per-step records, t = L-1 down to 0.

    hist[t] = (token [B,W], parent [B,W], alpha [B,W,K], beta [B,W]): slot
    w's token at step t came from source row parent[:, w] of step t-1's
    slots, and alpha/beta are the maps each SOURCE row of step t produced.
    Returns (ids [B,W,L], attention [B,W,L,K], beta [B,W,L]) of the final
    slots' paths, each step's maps taken from the row that produced the
    path's token."""
    B, W, K = hist[0][2].shape
    ptr = torch.arange(W, device=hist[0][0].device).expand(B, W)
    ids, atts, betas = [], [], []
    for tok_t, par_t, alpha_t, beta_t in reversed(hist):
        ids.append(tok_t.gather(1, ptr))
        src = par_t.gather(1, ptr)
        atts.append(alpha_t.gather(1, src[..., None].expand(B, W, K)))
        betas.append(beta_t.gather(1, src))
        ptr = src
    return torch.stack(ids[::-1], 2), torch.stack(atts[::-1], 2), torch.stack(betas[::-1], 2)


def make_beam_decoder(model, cf, beam_size: int = None, length_alpha: float = 0.0):
    """Returns decode(net, images_u8) -> BeamOutput, beam width beam_size
    (cf.beam_size when None). images_u8 and net as make_greedy_decoder's;
    traced by torch.export, early exit runs as make_greedy_decoder's does.

    On the fused path of the adaptive variant with cf.decode_beam_major
    (the default), V/pv stay untiled and the cell kernel reads each image's
    slots once for its W beam rows, at every width. decode_beam_major=False,
    and the other variants, whose cells run op by op, repeat V/pv per beam
    row (the tiled layout, as the JAX package's beam.py:46-57); the outputs
    are the same."""
    require_lstm(model, "beam search")
    W = beam_size if beam_size is not None else cf.beam_size
    if W < 1:
        raise ValueError(f"beam_size must be >= 1, got {W}")
    max_len = cf.decode_max_len
    start, eos = cf.decode_start_token, cf.decode_eos_token
    size = cf.train_crop_size
    sentinel_prev = cf.sampler_sentinel_uses_prev_hidden
    early_exit = cf.decode_early_exit
    beam_major = (model.fused and model.variant == "adaptive_attention"
                  and cf.decode_beam_major)
    mesh = spmd.decode_mesh(model, cf)
    prepare = prepare_cached(model, mesh)

    def preprocess(images_u8):
        return eval_preprocess(torch.as_tensor(images_u8, device=model.device), size,
                               model.compute_dtype)

    @torch.no_grad()
    def decode_images(prepared, images) -> BeamOutput:
        dev = model.device
        V, v_g, h0, c0 = model.encode_inference(prepared, images)
        dec, head, cell = prepared["decoder"], prepared["head"], prepared["cell"]
        tp_group, head_tp = prepared.get("tp") or (None, False)
        B, K = V.shape[0], V.shape[1]

        def tile(x):  # [B, ...] -> [B*W, ...], batch-major
            return x.repeat_interleave(W, 0)

        vg_t = tile(v_g)
        pv = model.precompute_slots(dec, V)
        if beam_major:
            V_t, pv_t, beam_w = V, pv, W
        else:
            V_t, pv_t, beam_w = tile(V), tile(pv), 1
        dstate = model.init_decode_state(tile(h0), tile(c0))

        first = torch.arange(W, device=dev) == 0
        # only beam 0 is alive at step 0, so identical expansions don't duplicate
        scores = torch.where(first, 0.0, NEG_INF).to(torch.float32).expand(B, W)
        # a finished beam's candidates: <end> at no cost, then dead ones
        eos_row = torch.where(first, 0.0, NEG_INF).to(torch.float32)
        tokens = torch.full((B, W), start, dtype=torch.int32, device=dev)
        finished = torch.zeros((B, W), dtype=torch.bool, device=dev)
        img = torch.arange(B, device=dev)

        def gather_beams(x, src):  # [B*W, ...] rows reordered by source beam
            return x.reshape(B, W, *x.shape[1:])[img[:, None], src].reshape(B * W, *x.shape[1:])

        hist = []  # per step: (token [B,W], parent [B,W], alpha [B,W,K], beta [B,W])
        traced = tracing(V)  # torch.export: no break on data
        for _ in range(max_len):
            logp_top, tok_top, alpha, beta, dstate = model.beam_decode_step(
                dec, tokens.reshape(B * W), vg_t, dstate, V_t, W, sentinel_prev,
                pv=pv_t, head=head, beam_w=beam_w, cell_t=cell, tp_group=tp_group,
                head_tp=head_tp)
            if early_exit and traced:  # the steps after the exit: zero maps
                live = ~finished.all()
                alpha, beta = alpha * live, beta * live
            logp_top = torch.where(finished[..., None], eos_row, logp_top.reshape(B, W, W))
            tok_top = tok_top.reshape(B, W, W).masked_fill(finished[..., None], eos)
            cand = scores[..., None] + logp_top  # [B, W, W] fp32
            scores, top_idx = topk_lower_index_first(cand.reshape(B, W * W), W)
            src = top_idx // W
            new_tok = tok_top.reshape(B, W * W).gather(1, top_idx)
            dstate = DecodeState(*(gather_beams(x, src) for x in dstate))
            finished = finished.gather(1, src) | (new_tok == eos)
            # step-t maps belong to the SOURCE row: stored raw, resolved below
            hist.append((new_tok, src, alpha.float().reshape(B, W, K),
                         beta.float().reshape(B, W)))
            tokens = new_tok
            if early_exit and not traced and bool(finished.all()):
                break
        # early exit: the fixed loop's all-finished steps. Scores are sorted
        # after every step and ties rank the lower flat index first, so the
        # forced <end> candidates keep slot order: parents are the identity
        # and tokens <end>. Alpha and beta there are zeros where the fixed
        # loop has post-<end> values; ids and scores are the same.
        ident = torch.arange(W, device=dev).expand(B, W)
        for _ in range(max_len - len(hist)):
            hist.append((torch.full_like(tokens, eos), ident,
                         torch.zeros_like(hist[-1][2]), torch.zeros_like(hist[-1][3])))

        all_ids, att_buf, beta_buf = backtrack(hist)

        if length_alpha > 0:
            before_eos = torch.cumsum((all_ids == eos).to(torch.int32), dim=-1) == 0
            lengths = before_eos.sum(-1) + 1
            scores = scores / lengths.to(torch.float32) ** length_alpha
        best = torch.argmax(scores, dim=1)  # first maximum
        return BeamOutput(ids=all_ids[img, best], score=scores[img, best], all_ids=all_ids,
                          all_scores=scores, attention=att_buf[img, best], beta=beta_buf[img, best])

    decode_prepared = spmd.wrap_decode_body(
        lambda prepared, images_u8: decode_images(prepared, preprocess(images_u8)), mesh)

    def decode(net, images_u8) -> BeamOutput:
        if mesh is not None:
            return decode_prepared(prepare(net), images_u8)
        images = preprocess(images_u8)  # queued first: the card resizes while prepare checks the weights
        return decode_images(prepare(net), images)

    decode.prepare = prepare
    decode.decode_prepared = decode_prepared
    return decode
