"""ROUGE-L — clean-room reimplementation.

Reference parity: coco/pycocoevalcap/rouge/rouge.py:13-105 — LCS length per
reference, max precision and max recall taken independently over references,
F-beta with beta=1.2. Note the reference splits on single spaces (" "), so an
empty hypothesis still yields one empty token; replicated via the same split.

The PyTorch port's own copy of adaptive_tpu/evalcap/rouge.py: the same code,
so the port scores captions without importing the JAX package.
"""

from __future__ import annotations

from typing import Dict, List


def lcs_length(a: List[str], b: List[str]) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = [0] * (len(b) + 1)
        ai = a[i - 1]
        for j in range(1, len(b) + 1):
            cur[j] = prev[j - 1] + 1 if ai == b[j - 1] else max(prev[j], cur[j - 1])
        prev = cur
    return prev[len(b)]


class Rouge:
    def __init__(self, beta: float = 1.2):
        self.beta = beta

    def method(self) -> str:
        return "Rouge"

    def calc_score(self, candidate: List[str], refs: List[str]) -> float:
        assert len(candidate) == 1 and len(refs) > 0
        token_c = candidate[0].split(" ")
        prec, rec = [], []
        for reference in refs:
            token_r = reference.split(" ")
            l = lcs_length(token_r, token_c)
            prec.append(l / float(len(token_c)))
            rec.append(l / float(len(token_r)))
        prec_max, rec_max = max(prec), max(rec)
        if prec_max != 0 and rec_max != 0:
            return ((1 + self.beta**2) * prec_max * rec_max) / (rec_max + self.beta**2 * prec_max)
        return 0.0

    def compute_score(self, gts: Dict, res: Dict):
        assert gts.keys() == res.keys()
        scores = [self.calc_score(res[iid], gts[iid]) for iid in gts.keys()]
        mean = sum(scores) / len(scores) if scores else 0.0
        return mean, scores
