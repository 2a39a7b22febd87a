"""Caption evaluation orchestrator.

Reference parity: COCOEvalCap (coco/pycocoevalcap/eval.py:8-73) — collect
gts/res per image id, PTB-tokenize both, run Bleu(4)/METEOR/ROUGE_L/CIDEr,
record per-metric corpus scores and per-image scores.

The PyTorch port's own copy of adaptive_tpu/evalcap/eval.py: the same code,
so the port scores captions without importing the JAX package.
"""

from __future__ import annotations

from typing import Dict, List

from adaptive_tpu_torch.evalcap.bleu import Bleu
from adaptive_tpu_torch.evalcap.cider import Cider
from adaptive_tpu_torch.evalcap.meteor import Meteor, default_tables
from adaptive_tpu_torch.evalcap.ptbtokenizer import PTBTokenizer
from adaptive_tpu_torch.evalcap.rouge import Rouge


class COCOEvalCap:
    def __init__(self, coco, cocoRes):
        self.evalImgs: List[dict] = []
        self.eval: Dict[str, float] = {}
        self.imgToEval: Dict = {}
        self.coco = coco
        self.cocoRes = cocoRes
        self.params = {"image_id": coco.getImgIds()}

    def evaluate(self):
        imgIds = self.params["image_id"]
        gts = {i: self.coco.imgToAnns[i] for i in imgIds}
        res = {i: self.cocoRes.imgToAnns[i] for i in imgIds}

        print("tokenization...")
        tokenizer = PTBTokenizer()
        gts = tokenizer.tokenize(gts)
        res = tokenizer.tokenize(res)

        print("setting up scorers...")
        scorers = [
            (Bleu(4), ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]),
            # stages 3-4 run on the resolved production tables (env-pluggable
            # WordNet data, packaged starter tables, or off — meteor.py)
            (Meteor(tables=default_tables()), "METEOR"),
            (Rouge(), "ROUGE_L"),
            (Cider(), "CIDEr"),
        ]

        for scorer, method in scorers:
            print("computing %s score..." % scorer.method())
            score, scores = scorer.compute_score(gts, res)
            if isinstance(method, list):
                for sc, scs, m in zip(score, scores, method):
                    self.setEval(sc, m)
                    self.setImgToEvalImgs(scs, gts.keys(), m)
                    print("%s: %0.3f" % (m, sc))
            else:
                self.setEval(score, method)
                self.setImgToEvalImgs(scores, gts.keys(), method)
                print("%s: %0.3f" % (method, score))
        self.setEvalImgs()

    def setEval(self, score, method):
        self.eval[method] = score

    def setImgToEvalImgs(self, scores, imgIds, method):
        for imgId, score in zip(imgIds, scores):
            if imgId not in self.imgToEval:
                self.imgToEval[imgId] = {"image_id": imgId}
            self.imgToEval[imgId][method] = score

    def setEvalImgs(self):
        self.evalImgs = [e for _, e in self.imgToEval.items()]
