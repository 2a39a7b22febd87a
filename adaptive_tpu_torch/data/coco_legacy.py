"""Legacy pycocotools v1.0.1 API surface (clean-room compat layer;
counterpart of adaptive_tpu/data/coco_legacy.py, the same code on the port's
own mask library, adaptive_tpu_torch/native/mask.py).

Reference parity: coco/pycocotools/coco.py (the py2-era v1.0.1 API vendored
next to the v2 one; imported nowhere in the reference's code_src, but part of
its public surface). Users migrating v1-era scripts get the same call
signatures and data shapes here; the implementation is numpy-vectorized and
shares the framework's native mask lib, not a transcription of the original.
Behavior is pinned by tests/test_coco_legacy.py, which imports the
reference's own v1 class as the differential oracle, and the port's by
tests/test_torch_detection.py against the JAX package's.

v1 quirks preserved (they differ from the v2 API and callers may rely on
them): uncompressed-RLE dicts for decodeMask/encodeMask (column-major runs,
leading zero-count when the mask starts with 1, coco.py:307-347);
``dataset['type']`` gating of the category index and the iscrowd filter
(coco.py:91-99,139-146); loadRes annotation ids numbered from 0 where the v2
API numbers from 1 (coco.py:283); loadRes segmentation area computed as
sum(counts[2:-1:2]) over the uncompressed counts (coco.py:297-301).

Intentional differences (each loud, none silent):
* ``info()`` works — the reference's always crashes on a typo
  (``self.datset``, coco.py:113-114).
* ``segToMask`` rasterizes via the native maskApi frPoly scanline instead of
  skimage.draw.polygon; boundary pixels can differ by the usual
  half-open-vs-centroid convention.
* ``showAnns`` imports matplotlib lazily (no hard viz dependency).
"""

from __future__ import annotations

import copy
import json
from collections import defaultdict
from typing import Dict, List

import numpy as np


def _listify(x):
    return x if isinstance(x, list) else [x]


class COCO:
    """v1.0.1-compatible COCO API (coco/pycocotools/coco.py:56-368)."""

    def __init__(self, annotation_file: str = None):
        self.dataset: Dict = {}
        self.anns = []
        self.imgToAnns = {}
        self.catToImgs = {}
        self.imgs = []
        self.cats = []
        if annotation_file is not None:
            print("loading annotations into memory...")
            with open(annotation_file) as f:
                self.dataset = json.load(f)
            self.createIndex()

    @property
    def _is_instances(self) -> bool:
        return self.dataset["type"] == "instances"

    def createIndex(self):
        print("creating index...")
        by_img = defaultdict(list)
        by_id = {}
        for a in self.dataset["annotations"]:
            by_img[a["image_id"]].append(a)
            by_id[a["id"]] = a
        self.anns = by_id
        self.imgToAnns = dict(by_img)
        self.imgs = {im["id"]: im for im in self.dataset["images"]}
        # v1 gates the category index on dataset type: caption datasets keep
        # the empty-list placeholders from __init__ (coco.py:91-99)
        if self._is_instances:
            self.cats = {c["id"]: c for c in self.dataset["categories"]}
            cat_imgs = defaultdict(list)
            for a in self.dataset["annotations"]:
                cat_imgs[a["category_id"]].append(a["image_id"])
            self.catToImgs = {c: cat_imgs.get(c, []) for c in self.cats}
        else:
            self.cats, self.catToImgs = [], []
        print("index created!")

    def info(self):
        # fixed: the reference reads self.datset and always crashes
        for k, v in self.dataset["info"].items():
            print(f"{k}: {v}")

    # -------------------------------------------------------------- getters
    def getAnnIds(self, imgIds=[], catIds=[], areaRng=[], iscrowd=None):
        imgIds, catIds = _listify(imgIds), _listify(catIds)
        if imgIds or catIds or areaRng:
            pool = (
                [a for i in imgIds for a in self.imgToAnns.get(i, [])]
                if imgIds
                else self.dataset["annotations"]
            )
            if catIds:
                pool = [a for a in pool if a["category_id"] in catIds]
            if areaRng:
                lo, hi = areaRng[0], areaRng[1]
                pool = [a for a in pool if lo < a["area"] < hi]
        else:
            pool = self.dataset["annotations"]
        # the iscrowd filter only exists for instance datasets (coco.py:139-146)
        if iscrowd is not None and self._is_instances:
            pool = [a for a in pool if a["iscrowd"] == iscrowd]
        return [a["id"] for a in pool]

    def getCatIds(self, catNms=[], supNms=[], catIds=[]):
        pool = self.dataset["categories"]
        for key, wanted in (
            ("name", _listify(catNms)),
            ("supercategory", _listify(supNms)),
            ("id", _listify(catIds)),
        ):
            if wanted:
                pool = [c for c in pool if c[key] in wanted]
        return [c["id"] for c in pool]

    def getImgIds(self, imgIds=[], catIds=[]):
        imgIds, catIds = _listify(imgIds), _listify(catIds)
        if not imgIds and not catIds:
            return list(self.imgs.keys())
        out = set(imgIds)
        for c in catIds:
            out = set(self.catToImgs[c]) if not out else out & set(self.catToImgs[c])
        return list(out)

    def _load(self, table, ids):
        if isinstance(ids, int):
            return [table[ids]]
        if isinstance(ids, list):
            return [table[i] for i in ids]

    def loadAnns(self, ids=[]):
        return self._load(self.anns, ids)

    def loadCats(self, ids=[]):
        return self._load(self.cats, ids)

    def loadImgs(self, ids=[]):
        return self._load(self.imgs, ids)

    def showAnns(self, anns):
        if not anns:
            return 0
        if self.dataset["type"] == "captions":
            for a in anns:
                print(a["caption"])
            return
        # instances rendering wants matplotlib; imported lazily on purpose
        import matplotlib.pyplot as plt
        from matplotlib.collections import PatchCollection
        from matplotlib.patches import Polygon

        ax = plt.gca()
        patches, colors = [], []
        for a in anns:
            tint = np.random.random(3).tolist()
            seg = a["segmentation"]
            if isinstance(seg, list):
                for poly in seg:
                    pts = np.asarray(poly, float).reshape(-1, 2)
                    patches.append(Polygon(pts, closed=True, alpha=0.4))
                    colors.append(tint)
            else:
                m = COCO.decodeMask(seg)
                tint = [2 / 255, 166 / 255, 101 / 255] if a["iscrowd"] else tint
                overlay = np.empty(m.shape + (4,))
                overlay[..., :3] = tint
                overlay[..., 3] = m * 0.5
                ax.imshow(overlay)
        ax.add_collection(
            PatchCollection(
                patches, facecolors=colors, edgecolors=(0, 0, 0, 1),
                linewidths=3, alpha=0.4,
            )
        )

    # -------------------------------------------------------------- results
    def loadRes(self, resFile: str) -> "COCO":
        res = COCO()
        res.dataset = {
            "images": list(self.dataset["images"]),
            "info": copy.deepcopy(self.dataset["info"]),
            "type": copy.deepcopy(self.dataset["type"]),
            "licenses": copy.deepcopy(self.dataset["licenses"]),
        }

        print("Loading and preparing results...     ")
        with open(resFile) as f:
            anns = json.load(f)
        if not isinstance(anns, list):
            raise AssertionError("results must be a list of annotation objects")
        result_img_ids = {a["image_id"] for a in anns}
        if not result_img_ids <= set(self.getImgIds()):
            raise AssertionError("results reference image ids outside this COCO set")

        if "caption" in anns[0]:
            kind = "caption"
        elif "bbox" in anns[0] and anns[0]["bbox"] != []:
            kind = "bbox"
        else:
            kind = "segmentation"
        if kind == "caption":
            res.dataset["images"] = [
                im for im in res.dataset["images"] if im["id"] in result_img_ids
            ]
        else:
            res.dataset["categories"] = copy.deepcopy(self.dataset["categories"])
        for new_id, a in enumerate(anns):
            a["id"] = new_id  # v1 numbers results from 0 (the v2 API uses 1)
            if kind == "bbox":
                x, y, w, h = a["bbox"]
                a["segmentation"] = [[x, y, x, y + h, x + w, y + h, x + w, y]]
                a["area"] = w * h
                a["iscrowd"] = 0
            elif kind == "segmentation":
                # v1 quirk: area from every other uncompressed count
                a["area"] = sum(a["segmentation"]["counts"][2:-1:2])
                a["bbox"] = []
                a["iscrowd"] = 0
        res.dataset["annotations"] = anns
        res.createIndex()
        return res

    # ---------------------------------------------------------- mask statics
    @staticmethod
    def decodeMask(R):
        """Uncompressed-RLE dict {'size': [h, w], 'counts': [...]} -> mask.

        Column-major runs alternating 0,1,0,... (coco.py:307-323); returned
        as the reference does: float array of 0.0/1.0."""
        counts = np.asarray(R["counts"], dtype=np.int64)
        values = np.arange(len(counts)) % 2  # 0,1,0,1,...
        flat = np.repeat(values.astype(float), counts)
        return flat.reshape(R["size"], order="F")

    @staticmethod
    def encodeMask(M):
        """Binary mask -> uncompressed-RLE dict (coco.py:325-347): column-major
        runs, with a leading zero count when the mask starts with 1."""
        flat = np.asarray(M, dtype=bool).ravel(order="F")
        boundaries = np.flatnonzero(np.diff(flat))
        runs = np.diff(np.concatenate(([0], boundaries + 1, [flat.size])))
        counts = ([0] if flat[0] else []) + runs.tolist()
        return {"size": list(M.shape), "counts": counts}

    @staticmethod
    def segToMask(S: List[List[float]], h: int, w: int):
        """Polygon list -> bool mask via the native maskApi scanline
        (frPoly); the reference used skimage.draw.polygon (coco.py:349-361)."""
        from adaptive_tpu_torch.native import mask as maskUtils

        rles = maskUtils.frPyObjects(S, h, w)
        merged = maskUtils.merge(rles if isinstance(rles, list) else [rles])
        return maskUtils.decode(merged).astype(bool)
