"""Corpus BLEU-1..4 — clean-room reimplementation.

Reference parity: coco/pycocoevalcap/bleu/bleu_scorer.py:23-264 and
bleu/bleu.py:14-47 — clipped n-gram counts against per-image max reference
counts, 'closest' effective reference length (falling back to 'average' for a
single image), brevity penalty exp(1 - 1/ratio) applied only when ratio < 1,
and the same tiny/small epsilons so scores agree to float precision.

The PyTorch port's own copy of adaptive_tpu/evalcap/bleu.py: the same code,
so the port scores captions without importing the JAX package.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Tuple

SMALL = 1e-9
TINY = 1e-15


def ngram_counts(words: List[str], n: int = 4) -> Dict[Tuple[str, ...], int]:
    counts: Dict[Tuple[str, ...], int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i : i + k])] += 1
    return counts


def _closest_reflen(reflens: List[int], testlen: int) -> int:
    return min((abs(l - testlen), l) for l in reflens)[1]


class Bleu:
    def __init__(self, n: int = 4):
        self.n = n

    def method(self) -> str:
        return "Bleu"

    def compute_score(self, gts: Dict, res: Dict):
        """gts/res: {img_id: [tokenized sentence strings]}; res has 1 per image.

        Returns ([bleu1..4], [per-image lists of bleu1..4]).
        """
        assert gts.keys() == res.keys()
        img_ids = list(gts.keys())
        n = self.n
        # The reference wrapper always passes option='closest' (bleu.py:40),
        # overriding the scorer's single-image 'average' default.
        option = "closest"

        total_guess = [0] * n
        total_correct = [0] * n
        total_testlen = 0
        total_reflen = 0.0
        bleu_list: List[List[float]] = [[] for _ in range(n)]

        for iid in img_ids:
            hyp = res[iid]
            refs = gts[iid]
            assert len(hyp) == 1 and len(refs) >= 1
            hyp_words = hyp[0].split()
            testlen = len(hyp_words)
            hyp_counts = ngram_counts(hyp_words, n)

            # per-image max reference counts (clipping caps)
            maxcounts: Dict[Tuple[str, ...], int] = {}
            reflens: List[int] = []
            for ref in refs:
                ref_words = ref.split()
                reflens.append(len(ref_words))
                for ng, c in ngram_counts(ref_words, n).items():
                    maxcounts[ng] = max(maxcounts.get(ng, 0), c)

            reflen = (
                float(_closest_reflen(reflens, testlen))
                if option == "closest"
                else float(sum(reflens)) / len(reflens)
            )

            guess = [max(0, testlen - k) for k in range(n)]
            correct = [0] * n
            for ng, c in hyp_counts.items():
                correct[len(ng) - 1] += min(maxcounts.get(ng, 0), c)

            total_testlen += testlen
            total_reflen += reflen
            for k in range(n):
                total_guess[k] += guess[k]
                total_correct[k] += correct[k]

            # per-image bleu (bleu_scorer.py:232-240)
            bleu = 1.0
            ratio = (testlen + TINY) / (reflen + SMALL)
            for k in range(n):
                bleu *= (correct[k] + TINY) / (guess[k] + SMALL)
                b = bleu ** (1.0 / (k + 1))
                if ratio < 1:
                    b *= math.exp(1 - 1 / ratio)
                bleu_list[k].append(b)

        # corpus bleu (bleu_scorer.py:248-257)
        bleus: List[float] = []
        bleu = 1.0
        ratio = (total_testlen + TINY) / (total_reflen + SMALL)
        for k in range(n):
            bleu *= (total_correct[k] + TINY) / (total_guess[k] + SMALL)
            b = bleu ** (1.0 / (k + 1))
            if ratio < 1:
                b *= math.exp(1 - 1 / ratio)
            bleus.append(b)
        return bleus, bleu_list
