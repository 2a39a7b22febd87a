"""CIDEr — clean-room reimplementation.

Reference parity: coco/pycocoevalcap/cider/cider_scorer.py:47-192 and
cider/cider.py:13-54 — tf-idf n-gram vectors (n=1..4) with document frequency
counted once per image over its references, idf = log(N) - log(max(1, df)),
clipped cosine similarity min(h,r)*r / (|h||r|), per-n gaussian length
penalty exp(-(lh-lr)^2 / (2*sigma^2)) with sigma=6, mean over n, mean over
refs, x10. The reference's length variable counts *bigrams* (n==1 index,
cider_scorer.py:128-129); replicated for bit-parity.

The PyTorch port's own copy of adaptive_tpu/evalcap/cider.py: the same code,
so the port scores captions without importing the JAX package.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Tuple

from adaptive_tpu_torch.evalcap.bleu import ngram_counts


class Cider:
    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def method(self) -> str:
        return "CIDEr"

    def compute_score(self, gts: Dict, res: Dict):
        assert gts.keys() == res.keys()
        img_ids = list(gts.keys())
        n = self.n

        crefs = [[ngram_counts(r.split(), n) for r in gts[iid]] for iid in img_ids]
        ctest = [ngram_counts(res[iid][0].split(), n) for iid in img_ids]

        # document frequency: one count per image per distinct ref ngram
        # (cider_scorer.py:93-103)
        df: Dict[Tuple[str, ...], float] = defaultdict(float)
        for refs in crefs:
            for ng in set(ng for ref in refs for ng in ref):
                df[ng] += 1

        ref_len = math.log(float(len(crefs)))  # cider_scorer.py:162

        def counts2vec(cnts):
            vec = [defaultdict(float) for _ in range(n)]
            norm = [0.0] * n
            length = 0
            for ng, tf in cnts.items():
                idf = ref_len - math.log(max(1.0, df[ng]))
                k = len(ng) - 1
                vec[k][ng] = float(tf) * idf
                norm[k] += vec[k][ng] ** 2
                if k == 1:  # reference quirk: counts bigrams (cider_scorer.py:128)
                    length += tf
            return vec, [math.sqrt(x) for x in norm], length

        def sim(vh, vr, nh, nr, lh, lr):
            delta = float(lh - lr)
            val = [0.0] * n
            for k in range(n):
                for ng in vh[k]:
                    val[k] += min(vh[k][ng], vr[k][ng]) * vr[k][ng]
                if nh[k] != 0 and nr[k] != 0:
                    val[k] /= nh[k] * nr[k]
                val[k] *= math.exp(-(delta**2) / (2 * self.sigma**2))
            return val

        scores: List[float] = []
        for test, refs in zip(ctest, crefs):
            vec, norm, length = counts2vec(test)
            acc = [0.0] * n
            for ref in refs:
                vr, nr, lr = counts2vec(ref)
                s = sim(vec, vr, norm, nr, length, lr)
                for k in range(n):
                    acc[k] += s[k]
            score_avg = sum(acc) / n / len(refs) * 10.0
            scores.append(score_avg)
        mean = sum(scores) / len(scores) if scores else 0.0
        return mean, scores
