"""The check of served captions: the reference, fed each sampled image and
the tokens the program served for it, gives its logits at every served
position; the number compared is the widest gap by which a served token's
logit lies below the reference's best (0 where every served token is the
reference's own greedy choice). Valid for greedy tokens only. Beside it,
the encoder's outputs of the same images, as the timed decoder's own
prepared tree computes them, against the reference's (encoder_gap): the
decoder's rounding hides the trunk's from the logits."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.lib.program import reference_config, to_device
from benchmark.reference.compare import feature_gap, logit_gap, served_length
from benchmark.reference.model import Reference, tf32_off

BLOCK = 8  # rows of the reference at a time


def sample_rows(n: int, k: int, lengths: Sequence[int], seed: int) -> List[int]:
    """k of n answers drawn from seed, the longest (the first of the
    longest) among them."""
    rng = np.random.default_rng(seed)
    longest = int(np.argmax(lengths))
    rest = [i for i in range(n) if i != longest]
    picks = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return sorted([longest] + [rest[i] for i in picks])


@torch.no_grad()
def program_features(model, prepared, images_u8, crop: int) -> Tuple[torch.Tensor, ...]:
    """The port's encoder outputs (V, v_g, h0, c0) of uint8 NHWC images as
    its greedy decode makes them: model.encode_inference on the decoder's
    own prepared tree (decode.prepare(net)), the images through
    eval_preprocess; float32 on the host."""
    from adaptive_tpu_torch.ops.preprocess import eval_preprocess

    x = eval_preprocess(torch.as_tensor(images_u8, device=model.device), crop,
                        model.compute_dtype)
    return tuple(t.float().cpu() for t in model.encode_inference(prepared, x))


@torch.no_grad()
def served_check(config: Dict, weights: Dict[str, torch.Tensor], images_u8: torch.Tensor,
                 served: Sequence[Sequence[int]], betas: Sequence[Sequence[float]],
                 features: Sequence[torch.Tensor], device, control=None) -> Dict[str, float]:
    """{"logit_gap", "beta_gap", "encoder_gap"} of sampled answers.
    images_u8 [n, S, S, 3]; served[i]: the ids served for image i (the
    first <end> included, where there is one); betas[i]: the sentinel
    shares the program gave at its first positions (the adaptive variant's;
    empty lists otherwise). beta_gap is the largest |program beta -
    reference beta| over them. features: the program's (V, v_g, h0, c0) of
    the n images (program_features); encoder_gap is compare.feature_gap's.

    control: an operand rounding (reference/model.py::fp8_operand); the
    reference computed on it takes the program's place, fed the same
    tokens: at each position its own first token is the one read, and its
    sentinel shares and encoder outputs are the ones compared."""
    rcfg = reference_config(config)
    eos, start = config["decode_eos_token"], config["decode_start_token"]
    w = to_device(weights, device)
    ref = Reference(w, rcfg)
    low = Reference(w, rcfg, control) if control is not None else None
    out = {"logit_gap": 0.0, "beta_gap": 0.0, "encoder_gap": 0.0}
    with tf32_off():
        for s in range(0, len(served), BLOCK):
            rows = served[s:s + BLOCK]
            L = max(len(r) for r in rows)
            tok = torch.full((len(rows), L), eos, dtype=torch.long)
            for i, r in enumerate(rows):
                tok[i, :len(r)] = torch.as_tensor(list(r), dtype=torch.long)
            tok = tok.to(device)
            images = images_u8[s:s + BLOCK].to(device)
            feats = ref.encode(images)
            logits, _, beta = ref.served_logits(images, tok, start, feats)
            got_betas = betas[s:s + BLOCK]
            got_feats = [f[s:s + BLOCK] for f in features]
            picked = tok
            if low is not None:
                got_feats = low.encode(images)
                low_logits, _, low_beta = low.served_logits(images, tok, start, got_feats)
                picked = low_logits.argmax(-1)
                got_betas = [low_beta[i, :len(b)].tolist() for i, b in enumerate(got_betas)]
            out["encoder_gap"] = max(out["encoder_gap"], feature_gap(got_feats, feats))
            out["logit_gap"] = max(out["logit_gap"],
                                   logit_gap(logits, picked, [len(r) for r in rows]))
            for i, got in enumerate(got_betas):
                if len(got):
                    want = beta[i, :len(got)].double().cpu()
                    gap = (torch.as_tensor(list(got), dtype=torch.float64) - want).abs().max()
                    out["beta_gap"] = max(out["beta_gap"], float(gap))
    return out


def served_ids(ids_row, eos: int) -> List[int]:
    ids = [int(t) for t in ids_row]
    return ids[:served_length(ids, eos)]
