"""Minimal COCO caption-annotation API (clean-room).

Reference parity: the vendored pycocotools COCO class
(coco/PythonAPI/pycocotools/coco.py:70-433) as used by this pipeline — index
building (createIndex, coco.py:90-119), getImgIds/getAnnIds/loadImgs/loadAnns,
and loadRes for building a results-COCO from a caption results file
(coco.py:297-356). The port keeps the caption part: the mask, drawing and
download methods raise NotImplementedError (the detection/segmentation API
is not queued for the port, ROADMAP.md §1).

The PyTorch port's own copy of adaptive_tpu/data/coco_api.py: the same code,
so the port scores captions without importing the JAX package.
"""

from __future__ import annotations

import copy
import json
import time
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional, Union

_NOT_QUEUED = (
    "the COCO detection/segmentation API (masks, RLE, drawing, download) is not "
    "ported: it is not queued for the PyTorch port (ROADMAP.md §1, 'Not queued')"
)


class COCO:
    def __init__(self, annotation_file: Optional[str] = None):
        self.dataset: Dict[str, Any] = {}
        self.anns: Dict[int, dict] = {}
        self.imgs: Dict[int, dict] = {}
        self.cats: Dict[int, dict] = {}
        self.imgToAnns: Dict[int, List[dict]] = defaultdict(list)
        self.catToImgs: Dict[int, List[int]] = defaultdict(list)
        if annotation_file is not None:
            tic = time.time()
            with open(annotation_file) as f:
                self.dataset = json.load(f)
            assert isinstance(self.dataset, dict), "annotation file format not supported"
            print("loading annotations into memory... Done (t=%0.2fs)" % (time.time() - tic))
            self.createIndex()

    def createIndex(self):
        anns, imgs, cats = {}, {}, {}
        imgToAnns = defaultdict(list)
        catToImgs = defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            imgToAnns[ann["image_id"]].append(ann)
            anns[ann["id"]] = ann
            if "category_id" in ann:
                catToImgs[ann["category_id"]].append(ann["image_id"])
        for img in self.dataset.get("images", []):
            imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            cats[cat["id"]] = cat
        self.anns, self.imgs, self.cats = anns, imgs, cats
        self.imgToAnns, self.catToImgs = imgToAnns, catToImgs

    # ------------------------------------------------------------------ gets
    def getImgIds(self, imgIds: Union[int, Iterable[int]] = (), catIds: Union[int, Iterable[int]] = ()) -> List[int]:
        imgIds, catIds = _as_list(imgIds), _as_list(catIds)
        if not imgIds and not catIds:
            return list(self.imgs.keys())
        ids = set(imgIds) if imgIds else set(self.imgs.keys())
        for c in catIds:
            ids &= set(self.catToImgs[c])
        return [i for i in ids if i in self.imgs]

    def getAnnIds(
        self,
        imgIds: Union[int, Iterable[int]] = (),
        catIds: Union[int, Iterable[int]] = (),
        areaRng: Iterable[float] = (),
        iscrowd: Optional[bool] = None,
    ) -> List[int]:
        imgIds, catIds, areaRng = _as_list(imgIds), _as_list(catIds), list(areaRng)
        if imgIds:
            anns: List[dict] = []
            for i in imgIds:
                anns.extend(self.imgToAnns.get(i, []))
        else:
            anns = list(self.anns.values())
        if catIds:
            cset = set(catIds)
            anns = [a for a in anns if a.get("category_id") in cset]
        if areaRng:
            anns = [a for a in anns if areaRng[0] < a.get("area", 0) < areaRng[1]]
        if iscrowd is not None:
            anns = [a for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns]

    def getCatIds(self, catNms=(), supNms=(), catIds=()) -> List[int]:
        cats = list(self.cats.values())
        if catNms:
            cats = [c for c in cats if c["name"] in set(_as_list(catNms))]
        if supNms:
            cats = [c for c in cats if c.get("supercategory") in set(_as_list(supNms))]
        if catIds:
            cset = set(_as_list(catIds))
            cats = [c for c in cats if c["id"] in cset]
        return [c["id"] for c in cats]

    def loadImgs(self, ids: Union[int, Iterable[int]]) -> List[dict]:
        return [self.imgs[i] for i in _as_list(ids)]

    def loadAnns(self, ids: Union[int, Iterable[int]]) -> List[dict]:
        return [self.anns[i] for i in _as_list(ids)]

    def loadCats(self, ids: Union[int, Iterable[int]]) -> List[dict]:
        return [self.cats[i] for i in _as_list(ids)]

    # ------------------------------------------------------------------ misc
    def info(self):
        """Print the annotation file's info block (coco.py:121-127)."""
        for k, v in self.dataset.get("info", {}).items():
            print(f"{k}: {v}")

    def showAnns(self, anns: List[dict]):
        raise NotImplementedError(_NOT_QUEUED)

    def download(self, tarDir: Optional[str] = None, imgIds: Iterable[int] = ()):
        raise NotImplementedError(_NOT_QUEUED)

    def annToRLE(self, ann: dict):
        raise NotImplementedError(_NOT_QUEUED)

    def annToMask(self, ann: dict):
        raise NotImplementedError(_NOT_QUEUED)

    # --------------------------------------------------------------- results
    def loadRes(self, resFile: Union[str, List[dict]]) -> "COCO":
        """Build a results-COCO from a caption results file (coco.py:297-356).

        Results must reference image ids present in this COCO; each result
        gets a fresh annotation id.
        """
        res = COCO()
        res.dataset["images"] = [img for img in self.dataset.get("images", [])]
        if isinstance(resFile, str):
            with open(resFile) as f:
                anns = json.load(f)
        else:
            anns = copy.deepcopy(resFile)
        assert isinstance(anns, list), "results in not an array of objects"
        annsImgIds = [ann["image_id"] for ann in anns]
        assert set(annsImgIds) == (set(annsImgIds) & set(self.getImgIds())), (
            "Results do not correspond to current coco set"
        )
        if anns and "caption" in anns[0]:
            imgIds = set(i["id"] for i in res.dataset["images"]) & set(annsImgIds)
            res.dataset["images"] = [i for i in res.dataset["images"] if i["id"] in imgIds]
            for aid, ann in enumerate(anns):
                ann["id"] = aid + 1
        elif anns and "bbox" in anns[0] and anns[0]["bbox"] != []:
            res.dataset["categories"] = copy.deepcopy(self.dataset.get("categories", []))
            for aid, ann in enumerate(anns):
                bb = ann["bbox"]
                if "segmentation" not in ann:
                    x1, x2, y1, y2 = bb[0], bb[0] + bb[2], bb[1], bb[1] + bb[3]
                    ann["segmentation"] = [[x1, y1, x1, y2, x2, y2, x2, y1]]
                ann["area"] = bb[2] * bb[3]
                ann["id"] = aid + 1
                ann["iscrowd"] = 0
        elif anns and "segmentation" in anns[0]:
            raise NotImplementedError(_NOT_QUEUED)
        elif anns and "keypoints" in anns[0]:
            res.dataset["categories"] = copy.deepcopy(self.dataset.get("categories", []))
            for aid, ann in enumerate(anns):
                s = ann["keypoints"]
                x, y = s[0::3], s[1::3]
                x0, x1, y0, y1 = min(x), max(x), min(y), max(y)
                ann["area"] = (x1 - x0) * (y1 - y0)
                ann["id"] = aid + 1
                ann["bbox"] = [x0, y0, x1 - x0, y1 - y0]
        res.dataset["annotations"] = anns
        res.createIndex()
        return res


def _as_list(x) -> list:
    if x is None:
        return []
    # any non-string iterable (list/tuple/set/ndarray/generator) expands;
    # a scalar id wraps
    if not isinstance(x, (str, bytes)) and hasattr(x, "__iter__"):
        return list(x)
    return [x]
