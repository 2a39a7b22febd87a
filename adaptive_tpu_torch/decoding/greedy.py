"""Batched greedy decode (counterpart of adaptive_tpu/decoding/greedy.py).

Like the reference sampler, all decode_max_len steps run by default, from
<start>; finished rows keep emitting <end>, and captions are cut at the first
<end> downstream. ``decode_early_exit=True`` stops once every row has
emitted <end>: ids stay identical (the tail is filled with the <end> the
fixed loop would emit); attention and beta after the global exit are zeros.
Traced by torch.export (export.py), where the loop cannot break on data,
the early-exit decoder runs every step and zeroes attention and beta after
the exit step, which gives the same outputs.

The JAX package scans the step inside one compiled program; here the step is
a Python loop over eager calls, two kernel launches per step on the fused
path (ops/fused_step.py). In a process group of more than one rank the fused
decode runs over the config's mesh (decoding/spmd.py): every rank is handed
the whole batch and returns the whole batch's outputs.

A model with its own greedy loop, ``greedy_ids`` (the hybrid LM decoder,
models/hybrid_lm.py), runs that loop in place of the LSTM's: it has no
attention maps or sentinel, so its GreedyOutput's attention is [B, L, 0]
and its beta [B, 0].
"""

from __future__ import annotations

import operator
from typing import NamedTuple

import torch

from adaptive_tpu_torch.decoding import spmd
from adaptive_tpu_torch.ops.fused_step import tracing
from adaptive_tpu_torch.ops.preprocess import eval_preprocess
from adaptive_tpu_torch.utils.profiling import span


class GreedyOutput(NamedTuple):
    ids: torch.Tensor  # [B, L] int32 sampled token ids
    attention: torch.Tensor  # [B, L, K] spatial attention maps
    beta: torch.Tensor  # [B, L] sentinel share


_VERSION = operator.attrgetter("_version")


def prepare_cached(model, mesh=None):
    """model.prepare_inference (on `mesh`: this rank's slice) memoized on the weights' module and the
    version counters of its parameters and buffers, read once a call: a
    serving or bench loop pays it once per checkpoint, and a weight changed
    in place (an optimiser step, load_state_dict, a write under no_grad)
    prepares anew. The tensors are
    listed once per module (walking the module tree costs milliseconds a
    call), so a parameter or buffer replaced by another tensor object
    (``module.weight = nn.Parameter(...)``, ``load_state_dict(assign=True)``,
    ``.to()`` through ``param.data =``) is not seen: the cached preparation
    is served until ``get.clear()`` drops it."""
    cache = []  # [net, its parameters and buffers, their versions, prepared]

    def get(net):
        if not (cache and cache[0] is net):
            cache[:] = [net, (*net.parameters(), *net.buffers()), None, None]
        versions = tuple(map(_VERSION, cache[1]))
        if versions != cache[2]:
            get.misses += 1
            cache[2:] = [versions, model.prepare_inference(net, mesh)]
        else:
            get.hits += 1
        return cache[3]

    get.clear = cache.clear
    get.misses = 0
    get.hits = 0
    return get


def make_greedy_decoder(model, cf):
    """Returns decode(net, images_u8) -> GreedyOutput.

    images_u8: uint8 NHWC at any square size (numpy or tensor), resized to
    train_crop_size and normalized on model.device. net: the Encoder2Decoder
    holding the weights; its inference tree is prepared once (prepare_cached).

    Spans (utils/profiling.py::span): ``decode.preprocess`` (the images'
    copy to model.device, resize and normalisation), ``decode.encode``
    (model.encode_inference) and ``decode.loop`` (precompute_slots, the
    state's initialisation, the step loop and the stacking of its outputs).
    A hybrid LM's ``decode.loop`` is its ``greedy_ids``, which opens
    ``decode.prefill`` first.
    """
    max_len = cf.decode_max_len
    start, eos = cf.decode_start_token, cf.decode_eos_token
    size = cf.train_crop_size
    sentinel_prev = cf.sampler_sentinel_uses_prev_hidden
    early_exit = cf.decode_early_exit
    mesh = spmd.decode_mesh(model, cf)
    prepare = prepare_cached(model, mesh)

    def preprocess(images_u8):
        with span("decode.preprocess"):
            return eval_preprocess(torch.as_tensor(images_u8, device=model.device), size,
                                   model.compute_dtype)

    @torch.no_grad()
    def decode_images(prepared, images) -> GreedyOutput:
        with span("decode.encode"):
            encoded = model.encode_inference(prepared, images)
        with span("decode.loop"):
            return loop(prepared, *encoded)

    def decode_loop(prepared, V, v_g, h0, c0) -> GreedyOutput:
        dec, head, cell = prepared["decoder"], prepared["head"], prepared["cell"]
        tp_group, head_tp = prepared.get("tp") or (None, False)
        pv = model.precompute_slots(dec, V)  # hoisted out of the loop
        dstate = model.init_decode_state(h0, c0)
        B = V.shape[0]
        tok = torch.full((B,), start, dtype=torch.int32, device=model.device)
        finished = torch.zeros((B,), dtype=torch.bool, device=model.device)
        ids, alphas, betas = [], [], []
        traced = tracing(V)  # torch.export: no break on data (module docstring)
        for _ in range(max_len):
            nxt, alpha, beta, dstate = model.greedy_decode_step(
                dec, tok, v_g, dstate, V, sentinel_prev, pv=pv, head=head, cell_t=cell,
                tp_group=tp_group, head_tp=head_tp)
            if early_exit and traced:  # the steps after the exit: zero maps
                live = ~finished.all()
                alpha, beta = alpha * live, beta * live
            nxt = torch.where(finished, torch.full_like(nxt, eos), nxt)
            finished = finished | (nxt == eos)
            ids.append(nxt)
            alphas.append(alpha)
            betas.append(beta[:, 0])
            tok = nxt
            if early_exit and not traced and bool(finished.all()):
                break
        for _ in range(max_len - len(ids)):  # early exit: the fixed loop's tail
            ids.append(torch.full_like(ids[-1], eos))
            alphas.append(torch.zeros_like(alphas[-1]))
            betas.append(torch.zeros_like(betas[-1]))
        return GreedyOutput(ids=torch.stack(ids, 1), attention=torch.stack(alphas, 1),
                            beta=torch.stack(betas, 1))

    def lm_loop(prepared, A_flat) -> GreedyOutput:
        ids = model.greedy_ids(prepared, A_flat, max_len, start, eos, early_exit)
        B = A_flat.shape[0]
        return GreedyOutput(ids=ids, attention=A_flat.new_zeros((B, max_len, 0)),
                            beta=A_flat.new_zeros((B, 0)))

    # a language-model decoder supplies its own loop (models/hybrid_lm.py)
    loop = lm_loop if hasattr(model, "greedy_ids") else decode_loop

    decode_prepared = spmd.wrap_decode_body(
        lambda prepared, images_u8: decode_images(prepared, preprocess(images_u8)), mesh)

    def decode(net, images_u8) -> GreedyOutput:
        if mesh is not None:
            return decode_prepared(prepare(net), images_u8)
        images = preprocess(images_u8)  # queued first: the card resizes while prepare checks the weights
        return decode_images(prepare(net), images)

    decode.prepare = prepare
    decode.decode_prepared = decode_prepared
    return decode
