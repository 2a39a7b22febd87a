"""What the hybrid LM decoder's cell (kinds/offline_decode_hybrid.py) needs
beside the shared helpers: the seeded weights, the port built on them, the
model's FLOPs from its shapes, kernel 8's bytes, and the check of what the
window served against the plain reference (reference/granite_hybrid.py).

The configuration file holds the language model's published keys
(granite-4.0-h-micro's config.json) at its top level, as the port's
``hybrid_lm`` knob takes them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from benchmark.lib.flops import trunk_flops
from benchmark.lib.images import seeded_images
from benchmark.lib.program import CALIBRATION_IMAGES, synchronize
from benchmark.reference.compare import feature_gap, logit_gap
from benchmark.reference.granite_hybrid import (
    HybridReference, make_lm_weights, make_trunk_weights, sizes,
)
from benchmark.reference.model import TRUNK, calibrate_bn, slots

BLOCK = 16  # rows of the reference at a time
BYTES = {"bfloat16": 2, "float32": 4}


# ------------------------------------------------------------------ set-up
def seeded_weights(config: Dict, seed: int, device, mark=None) -> Dict[str, torch.Tensor]:
    """Float32 weights on device from seed: the trunk drawn and its BN
    statistics calibrated on CALIBRATION_IMAGES seeded images (seed + 1),
    then the projector and the language model."""
    w = make_trunk_weights(config, seed, device)
    calib = seeded_images(CALIBRATION_IMAGES, seed + 1, config["resized_image_size"], device)
    calibrate_bn(w, config, calib)
    w.update(make_lm_weights(config, seed, device))
    synchronize(device)
    if mark:
        mark("draw")
    return w


def trunk_part(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The trunk's tensors, on the host (the language model's are drawn
    again from the seed for the check)."""
    return {n: t.detach().cpu() for n, t in weights.items() if n.startswith(TRUNK)}


def build_port(cf, weights: Dict[str, torch.Tensor], device):
    """(HybridModel, HybridNet) of the port holding `weights` (strict: every
    state_dict name must match; the language model's cast to the compute
    dtype as it loads)."""
    from adaptive_tpu_torch.models.factory import build_model

    model = build_model(cf, device=device)
    net = model.new_net()
    net.load_state_dict(weights, strict=True)
    return model, net


# ------------------------------------------------------------------ work
def _token_linear_flops(s: Dict, kind: str) -> float:
    """A token's matrix products in one layer, outside the sequence mixing."""
    D = s["D"]
    f = 2.0 * D * 2 * s["I"] + 2.0 * s["I"] * D  # the shared MLP
    if kind == "mamba":
        f += 2.0 * D * (2 * s["inner"] + 2 * s["G"] * s["N"] + s["H"]) + 2.0 * s["inner"] * D
    else:
        f += 2.0 * D * (D + 2 * s["kv"] * s["hd"]) + 2.0 * D * D
    return f


def prefill_flops(config: Dict) -> float:
    """One image's prefill of its image tokens: the projector, each layer's
    products, the SSD scan's (C B^T, its product with x, the state's x^T B)
    and the attention's (q k^T and its product with v over all n^2 pairs)."""
    s = sizes(config)
    n = slots(config)
    f = 2.0 * n * (s["F"] * s["D"] + s["D"] * s["D"])
    for kind in s["types"]:
        f += n * _token_linear_flops(s, kind)
        if kind == "mamba":
            f += 2.0 * n * n * s["G"] * s["N"] + 2.0 * n * n * s["inner"] \
                + 2.0 * n * s["inner"] * s["N"]
        else:
            f += 4.0 * s["heads"] * s["hd"] * n * n
    return f


def step_flops(config: Dict, positions: int) -> float:
    """One row's decode step attending over `positions`: each layer's
    products, the state's x B^T and S C, the attention's, and the head."""
    s = sizes(config)
    f = 2.0 * s["D"] * s["V"]
    for kind in s["types"]:
        f += _token_linear_flops(s, kind)
        f += (4.0 * s["inner"] * s["N"] if kind == "mamba"
              else 4.0 * s["heads"] * s["hd"] * positions)
    return f


def decode_flops(config: Dict, images: int) -> float:
    """A greedy decode of `images`: the trunk, the projector and prefill,
    and decode_max_len steps."""
    n = slots(config)
    steps = sum(step_flops(config, n + t + 1) for t in range(config["decode_max_len"]))
    return images * (trunk_flops(config) + prefill_flops(config) + steps)


def ssm_step_work(config: Dict, rows: int) -> Tuple[float, float]:
    """(bytes, FLOPs) of one launch of kernel 8: the state and conv state
    read and written, the step's xBC and dt read, y written, the conv's
    weights and the heads' three fp32 vectors read; the conv's products and
    the state's x B^T and S C."""
    s = sizes(config)
    b = BYTES[config["compute_dtype"]]
    state = rows * s["inner"] * s["N"]
    conv = rows * (s["K"] - 1) * s["conv"]
    moved = (2 * (state + conv) + rows * (s["conv"] + s["H"] + s["inner"])
             + s["conv"] * (s["K"] + 1)) * b + 3 * s["H"] * 4
    return moved, 4.0 * state + 2.0 * rows * s["K"] * s["conv"]


# ------------------------------------------------------------------ the check
@torch.no_grad()
def replay(model, prepared, images_u8, fed: torch.Tensor, rows: Sequence[int], crop: int):
    """The program's image tokens [n, K, D] and logits [n, L, vocab] (float32,
    host) of `rows` of one whole batch: images_u8 [B, S, S, 3] through the
    encoder and the prefill, then teacher-forced with fed [B, L] through
    the decode steps, as the window's greedy decode runs them."""
    from adaptive_tpu_torch.ops.preprocess import eval_preprocess

    dev = model.device
    x = eval_preprocess(torch.as_tensor(images_u8, device=dev), crop, model.compute_dtype)
    (A,) = model.encode_inference(prepared, x)
    tokens = model.image_tokens(prepared, A)[list(rows)].float().cpu()
    cache = model.prefill(prepared, A, fed.shape[1])
    fed = fed.to(dev)
    logits = [model.step(prepared, fed[:, t], cache)[list(rows)].float().cpu()
              for t in range(fed.shape[1])]
    return tokens, torch.stack(logits, dim=1)


def fed_ids(served: torch.Tensor, start: int) -> torch.Tensor:
    """[B, L] ids of a batch -> what each step was fed: <start>, then the
    ids before it."""
    return torch.cat([torch.full_like(served[:, :1], start), served[:, :-1]], dim=1)


@torch.no_grad()
def served_check(config: Dict, seed: int, trunk: Dict[str, torch.Tensor], images_u8: torch.Tensor,
                 served: List[List[int]], tokens: torch.Tensor, logits: torch.Tensor, device,
                 control=None) -> Dict[str, float]:
    """{"logit_gap", "replay_logit_gap", "encoder_gap"} of sampled captions.
    images_u8 [n, S, S, 3]; served[i]: the ids served for image i (through
    its first <end>, where it has one); tokens [n, K, D] and logits [n, L,
    vocab]: the program's image tokens and teacher-forced logits of the
    rows (replay). The reference runs on the trunk's weights and the
    language model's drawn again from seed, in one pass over each row's
    image tokens and fed ids.

    logit_gap: compare.logit_gap of the served tokens under the
    reference's logits. replay_logit_gap: the largest ||program - reference||
    / ||reference|| of a row's logits at a served position. encoder_gap:
    compare.feature_gap of the image tokens.

    control: an operand rounding (reference/model.py::fp8_operand); the
    reference computed on it takes the program's place: its image tokens
    and logits are the ones compared, and its own first token at each
    position the one read."""
    eos, start = config["decode_eos_token"], config["decode_start_token"]
    w = {n: t.to(device) for n, t in trunk.items()}
    w.update(make_lm_weights(config, seed, device))
    ref = HybridReference(w, config)
    low = HybridReference(w, config, control) if control is not None else None
    out = {"logit_gap": 0.0, "replay_logit_gap": 0.0, "encoder_gap": 0.0}
    L = logits.shape[1]
    for s in range(0, len(served), BLOCK):
        rows = served[s:s + BLOCK]
        lengths = [len(r) for r in rows]
        tok = torch.full((len(rows), L), eos, dtype=torch.long)
        for i, r in enumerate(rows):
            tok[i, :len(r)] = torch.as_tensor(list(r), dtype=torch.long)
        tok = tok.to(device)
        want_tokens = ref.image_tokens(ref.trunk_map(images_u8[s:s + BLOCK].to(device)))
        want = ref.served_logits(want_tokens, tok, start)
        got_tokens, got, picked = tokens[s:s + BLOCK], logits[s:s + BLOCK], tok
        if low is not None:
            got_tokens = low.image_tokens(low.trunk_map(images_u8[s:s + BLOCK].to(device)))
            got = low.served_logits(got_tokens, tok, start)
            picked = got.argmax(-1)
        out["encoder_gap"] = max(out["encoder_gap"], feature_gap([got_tokens], [want_tokens]))
        out["logit_gap"] = max(out["logit_gap"], logit_gap(want, picked, lengths))
        got = got.to(device)
        gap = (got - want).norm(dim=-1) / want.norm(dim=-1)  # [rows, L]
        for i, n in enumerate(lengths):
            out["replay_logit_gap"] = max(out["replay_logit_gap"], float(gap[i, :n].max()))
    return out
