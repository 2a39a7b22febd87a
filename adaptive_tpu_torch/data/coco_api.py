"""Minimal COCO caption-annotation API (clean-room).

Reference parity: the vendored pycocotools COCO class
(coco/PythonAPI/pycocotools/coco.py:70-433) as used by this pipeline — index
building (createIndex, coco.py:90-119), getImgIds/getAnnIds/loadImgs/loadAnns,
and loadRes for building a results-COCO from a caption results file
(coco.py:297-356); the mask methods (annToRLE, annToMask, loadRes's
segmentation branch) run on the native RLE library (native/mask.py).

The PyTorch port's own copy of adaptive_tpu/data/coco_api.py: the same code
on the port's own mask library, so the port neither imports the JAX package
nor builds or loads its libraries.
"""

from __future__ import annotations

import copy
import json
import os
import time
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional, Union


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
        """Render annotations onto the current matplotlib axes (coco.py:233-295).

        Captions print; polygons/RLE masks draw translucent patches; keypoint
        annotations draw the category skeleton. matplotlib is imported lazily
        so headless pipelines never pay for it.
        """
        if not anns:
            return 0
        if "caption" in anns[0]:
            for a in anns:
                print(a["caption"])
            return
        if not ("segmentation" in anns[0] or "keypoints" in anns[0]):
            raise Exception("datasetType not supported")
        import numpy as np
        import matplotlib.pyplot as plt
        from matplotlib.collections import PatchCollection
        from matplotlib.patches import Polygon

        ax = plt.gca()
        ax.set_autoscale_on(False)
        patches, tints = [], []
        for a in anns:
            tint = (np.random.random(3) * 0.6 + 0.4).tolist()
            seg = a.get("segmentation")
            if isinstance(seg, list):
                for poly in seg:
                    pts = np.asarray(poly, float).reshape(-1, 2)
                    patches.append(Polygon(pts))
                    tints.append(tint)
            elif isinstance(seg, dict):
                from adaptive_tpu_torch.native import mask as maskUtils

                m = maskUtils.decode(self.annToRLE(a))
                mask_tint = (
                    np.array([2.0, 166.0, 101.0]) / 255
                    if a.get("iscrowd") == 1
                    else np.random.random(3)
                )
                overlay = np.empty(m.shape + (4,))
                overlay[..., :3] = mask_tint
                overlay[..., 3] = m * 0.5
                ax.imshow(overlay)
            if isinstance(a.get("keypoints"), list):
                skeleton = np.asarray(
                    self.loadCats(a["category_id"])[0]["skeleton"]
                ) - 1
                kp = np.asarray(a["keypoints"])
                x, y, v = kp[0::3], kp[1::3], kp[2::3]
                for bone in skeleton:
                    if np.all(v[bone] > 0):
                        plt.plot(x[bone], y[bone], linewidth=3, color=tint)
                for vis, edge in ((0, "k"), (1, tint)):
                    sel = v > vis
                    plt.plot(
                        x[sel], y[sel], "o", markersize=8,
                        markerfacecolor=tint, markeredgecolor=edge,
                        markeredgewidth=2,
                    )
        ax.add_collection(
            PatchCollection(patches, facecolor=tints, linewidths=0, alpha=0.4)
        )
        ax.add_collection(
            PatchCollection(patches, facecolor="none", edgecolors=tints, linewidths=2)
        )

    def download(self, tarDir: Optional[str] = None, imgIds: Iterable[int] = ()):
        """Fetch image files by their recorded URLs (coco.py:358-380)."""
        if tarDir is None:
            print("Please specify target directory")
            return -1
        from urllib.request import urlretrieve

        imgs = self.loadImgs(imgIds) if _as_list(imgIds) else list(self.imgs.values())
        os.makedirs(tarDir, exist_ok=True)
        for i, img in enumerate(imgs):
            tic = time.time()
            fname = os.path.join(tarDir, img["file_name"])
            if not os.path.exists(fname):
                urlretrieve(img["coco_url"], fname)
            print(f"downloaded {i}/{len(imgs)} images (t={time.time() - tic:0.1f}s)")

    def loadNumpyAnnotations(self, data) -> List[dict]:
        """[N,7] ndarray rows (imageID,x1,y1,w,h,score,class) -> result dicts
        (coco.py:382-403)."""
        import numpy as np

        data = np.asarray(data)
        assert data.ndim == 2 and data.shape[1] == 7, "expected an [N,7] array"
        return [
            {
                "image_id": int(row[0]),
                "bbox": [row[1], row[2], row[3], row[4]],
                "score": row[5],
                "category_id": int(row[6]),
            }
            for row in data
        ]

    # ----------------------------------------------------------------- masks
    def annToRLE(self, ann: dict):
        """Annotation segmentation (polygon | uncompressed RLE | RLE) -> RLE
        (pycocotools coco.py annToRLE semantics) via the native mask lib."""
        from adaptive_tpu_torch.native import mask as maskUtils

        img = self.imgs[ann["image_id"]]
        h, w = img["height"], img["width"]
        segm = ann["segmentation"]
        if isinstance(segm, list):
            rles = maskUtils.frPyObjects(segm, h, w)
            return maskUtils.merge(rles if isinstance(rles, list) else [rles])
        if isinstance(segm.get("counts"), list):
            # uncompressed RLE: counts list -> compact string via roundtrip
            import numpy as _np

            arr = _np.zeros(h * w, _np.uint8)
            pos, v = 0, 0
            for c in segm["counts"]:
                arr[pos : pos + c] = v
                pos += c
                v = 1 - v
            return maskUtils.encode(arr.reshape(w, h).T)
        return segm

    def annToMask(self, ann: dict):
        from adaptive_tpu_torch.native import mask as maskUtils

        return maskUtils.decode(self.annToRLE(ann))

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
            from adaptive_tpu_torch.native import mask as maskUtils

            res.dataset["categories"] = copy.deepcopy(self.dataset.get("categories", []))
            for aid, ann in enumerate(anns):
                ann["area"] = float(maskUtils.area(ann["segmentation"]))
                if "bbox" not in ann:
                    ann["bbox"] = maskUtils.toBbox(ann["segmentation"]).tolist()
                ann["id"] = aid + 1
                ann["iscrowd"] = 0
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
