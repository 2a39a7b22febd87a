"""Karpathy split stage: merge COCO train+val, shuffle, write 8 split JSONs
(counterpart of adaptive_tpu/data/karpathy_split.py, the same code).

Reference parity: code_src/data/KarpathySplit.py:8-69. The same seeded
``random.shuffle``/``random.sample`` calls in the same order, so a given
seed gives the identical split. Split sizes per cfg: val 5000 / test 5000 /
train (the rest, ~113287) / train_eval 5000 / train_overfit 20 (1 annotation
an image, KarpathySplit.py:64-67) / hyperparameter subsets 5000+1000+1000.
"""

from __future__ import annotations

import json
import os
from random import sample, seed, shuffle
from typing import Dict, List


def main_KarpathySplit(cf) -> Dict[str, dict]:
    seed(cf.train_random_seed)  # KarpathySplit.py:9

    with open(cf.captions_val_origin) as f:
        val = json.load(f)
    with open(cf.captions_train_origin) as f:
        train = json.load(f)

    imgs = val["images"] + train["images"]
    annots = val["annotations"] + train["annotations"]

    shuffle(imgs)

    dataset: Dict[str, List[dict]] = {}
    dataset["val"] = imgs[: cf.num_val]
    dataset["test"] = imgs[cf.num_val : cf.num_val + cf.num_test]
    dataset["train"] = imgs[cf.num_val + cf.num_test :]

    # subsets drawn with sorted sampled indices, in the reference's call
    # order (KarpathySplit.py:30-38), so the seeded stream matches
    dataset["train_eval"] = _subset(dataset["train"], cf.num_train_eval)
    dataset["val_hyperparameter"] = _subset(dataset["val"], cf.num_val_hyperparameter)
    dataset["train_hyperparameter"] = _subset(dataset["train"], cf.num_train_hyperparameter)
    dataset["train_eval_hyperparameter"] = _subset(
        dataset["train_hyperparameter"], cf.num_train_eval_hyperparameter
    )
    dataset["train_overfit"] = _subset(dataset["train"], cf.num_train_overfit)

    itoa: Dict[int, List[dict]] = {}
    for a in annots:
        itoa.setdefault(a["image_id"], []).append(a)

    info = train.get("info", {})
    licenses = train.get("licenses", [])
    out: Dict[str, dict] = {}
    os.makedirs(os.path.dirname(cf.splited_anno_path_prefix) or ".", exist_ok=True)
    for subset in dataset.keys():
        data = {
            "type": "caption",
            "info": info,
            "licenses": licenses,
            "images": [],
            "annotations": [],
        }
        for img in dataset[subset]:
            anns = itoa[img["id"]]
            data["images"].append(img)
            if subset == "train_overfit":  # 1 annotation an image, KarpathySplit.py:64-67
                data["annotations"].append(anns[0])
            else:
                data["annotations"].extend(anns)
        path = cf.splited_anno_path_prefix + subset + ".json"
        with open(path, "w") as f:
            json.dump(data, f)
        out[subset] = data
    return out


def _subset(items: List[dict], n: int) -> List[dict]:
    return [items[i] for i in sorted(sample(range(len(items)), n))]
