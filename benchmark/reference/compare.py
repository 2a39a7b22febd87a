"""The numbers that decide ``correct``: how far the program's outputs lie
from the reference's. Each is compared with its limit in the cell's traffic
file (``limits``); a number over its limit, a missing answer or a number
that is not finite makes the run not correct."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional, Tuple

import torch


def served_length(ids, eos: int) -> int:
    """Served tokens of a caption: through its first <end>, else all."""
    ids = [int(t) for t in ids]
    return ids.index(eos) + 1 if eos in ids else len(ids)


def logit_gap(ref_logits: torch.Tensor, served: torch.Tensor, lengths: Iterable[int]) -> float:
    """The widest gap by which a served token's reference logit lies below
    the reference's best at its position: ref_logits [B, L, vocab], served
    [B, L], each row compared over its first lengths[b] positions."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, served.long()[..., None])[..., 0]
    gap = 0.0
    for b, n in enumerate(lengths):
        if n:
            gap = max(gap, float((best[b, :n] - got[b, :n]).max()))
    return gap


def feature_gap(prog, ref) -> float:
    """The widest relative gap of the encoder's outputs: over rows b and the
    outputs (V, v_g, h0, c0), ||prog[b] - ref[b]|| / ||ref[b]||."""
    gap = 0.0
    for p, r in zip(prog, ref):
        p, r = p.double().flatten(1), r.double().flatten(1).to(p.device)
        gap = max(gap, float(((p - r).norm(dim=1) / r.norm(dim=1)).max()))
    return gap


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float]) -> Dict[str, float]:
    """{leaf: gap} over the leaves of ref: each leaf's |prog norm - ref norm|
    over the larger of its ref norm and the median leaf's; a leaf the
    program lacks reads norm 0."""
    med = statistics.median(ref.values())
    return {n: abs(prog.get(n, 0.0) - r) / max(r, med) for n, r in ref.items()}


def worst(gaps: Dict[str, float]) -> Tuple[float, str]:
    """(the largest gap, its leaf); inf where a gap is not finite."""
    name = max(gaps, key=lambda n: gaps[n] if math.isfinite(gaps[n]) else math.inf)
    v = gaps[name]
    return (v if math.isfinite(v) else math.inf), name


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def change_norms(after: Dict[str, torch.Tensor], before: Dict[str, torch.Tensor],
                 names) -> Dict[str, float]:
    return {n: float((after[n].double() - before[n].double()).norm()) for n in names}


def judge(numbers: Dict[str, Optional[float]], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """(correct, {name: {"value": v, "limit": l}}): every limited number
    present, finite and at most its limit."""
    shown, ok = {}, True
    for name, lim in limits.items():
        v = numbers.get(name)
        shown[name] = {"value": v, "limit": lim}
        if v is None or not math.isfinite(v) or v > lim:
            ok = False
    return ok, shown
