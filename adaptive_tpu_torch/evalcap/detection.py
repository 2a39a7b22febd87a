"""COCO detection evaluation (bbox / segm / keypoints AP) — clean-room, vectorized
(counterpart of adaptive_tpu/evalcap/detection.py: the same numpy code on the
port's own mask library, so its results equal the JAX package's exactly).

Reference parity: the vendored COCOeval
(coco/PythonAPI/pycocotools/cocoeval.py:10-533) — greedy per-image
per-category matching over 10 IoU thresholds with crowd/ignore semantics,
101-point interpolated precision, area-range and maxDets breakdowns, OKS for
keypoints, and the standard 12-stat (dets) / 10-stat (kps) summary.

Own design, not the vendored one's shape:
- Matching runs as numpy array ops on the [D, G] IoU matrix: one pass over
  detections, with the candidate ground-truth selection for ALL IoU
  thresholds at once ([T, G] masks, `_pick_last_max`), instead of the
  vendored T x D x G triple Python loop.
- Accumulation is batched cumsum / `np.maximum.accumulate` envelope /
  vectorized `searchsorted` over structured per-(category, area) record
  lists — no flat-index arithmetic into a global list.
- Per-image records keep the *public* pycocotools result schema (the
  `evalImgs` dict keys `dtMatches`/`gtIgnore`/... are the vendored API's
  documented output contract, same argument as the COCO method names), but
  every internal is original.

The captioning pipeline itself never calls this (cocoeval is vendored-unused
in the reference, SURVEY.md C23); it completes the COCO-API capability
surface. IoU computation uses the native C++ mask library
(adaptive_tpu_torch/native/masklib.cpp).
"""

from __future__ import annotations

import copy
import datetime
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from adaptive_tpu_torch.native import mask as maskUtils

OKS_SIGMAS = (
    np.array(
        [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07, .87, .87, .89, .89]
    )
    / 10.0
)


class Params:
    """Default evaluation parameters (cocoeval.py:499-534)."""

    def __init__(self, iouType: str = "segm"):
        self.imgIds: List[int] = []
        self.catIds: List[int] = []
        self.iouThrs = np.linspace(0.5, 0.95, int(round((0.95 - 0.5) / 0.05)) + 1, endpoint=True)
        self.recThrs = np.linspace(0.0, 1.00, int(round(1.00 / 0.01)) + 1, endpoint=True)
        if iouType in ("segm", "bbox"):
            self.maxDets = [1, 10, 100]
            self.areaRng = [[0, 1e5**2], [0, 32**2], [32**2, 96**2], [96**2, 1e5**2]]
            self.areaRngLbl = ["all", "small", "medium", "large"]
        elif iouType == "keypoints":
            self.maxDets = [20]
            self.areaRng = [[0, 1e5**2], [32**2, 96**2], [96**2, 1e5**2]]
            self.areaRngLbl = ["all", "medium", "large"]
        else:
            raise ValueError(f"iouType not supported: {iouType}")
        self.useCats = 1
        self.iouType = iouType


def _pick_last_max(values: np.ndarray, eligible: np.ndarray) -> np.ndarray:
    """Per row of `eligible` [T, G]: index of the LAST occurrence of the
    maximum of `values` [G] among eligible entries, or -1 if none.

    "Last occurrence" reproduces the vendored scan's update rule exactly: a
    candidate replaces the running best whenever it is >= (not strictly >)
    the best so far, so ties resolve to the highest ground-truth index
    (cocoeval.py:270-280 semantics, re-derived — see tests for bit parity).
    """
    n_rows, n_cols = eligible.shape
    if n_cols == 0:
        return np.full(n_rows, -1, np.int64)
    masked = np.where(eligible, values[None, :], -np.inf)
    # argmax of the reversed row = first max from the right = last max
    last_max = n_cols - 1 - np.argmax(masked[:, ::-1], axis=1)
    found = np.isfinite(masked[np.arange(n_rows), last_max])
    return np.where(found, last_max, -1)


def _greedy_match(
    iou: np.ndarray, gt_ignored: np.ndarray, gt_crowd: np.ndarray, thresholds: np.ndarray
) -> np.ndarray:
    """Greedy score-order matching, all IoU thresholds at once.

    iou: [D, G] with detections score-sorted and ground truths sorted so all
    non-ignored entries precede ignored ones. Returns [T, D] matched gt index
    (into the sorted gt order) or -1.

    Semantics (equal to cocoeval.py:266-286 by construction):
    - a detection first looks among non-ignored ground truths that are still
      open; only if none qualifies does it consider ignored ones (the
      vendored early-`break` relies on the same ignored-last sort order);
    - a ground truth is open until matched, except crowds which stay open;
    - a candidate must reach min(threshold, 1-1e-10), and among candidates
      the best IoU wins with ties to the highest index (`_pick_last_max`).
    """
    n_thr = len(thresholds)
    n_det, n_gt = iou.shape
    floors = np.minimum(thresholds, 1 - 1e-10)[:, None]  # [T, 1]
    ignored_row = gt_ignored.astype(bool)[None, :]        # [1, G]
    crowd_row = gt_crowd.astype(bool)[None, :]
    open_gt = np.ones((n_thr, n_gt), bool)
    matches = np.full((n_thr, n_det), -1, np.int64)
    if n_gt == 0:
        return matches
    rows = np.arange(n_thr)
    for d in range(n_det):
        reaches = iou[d][None, :] >= floors                       # [T, G]
        available = open_gt | crowd_row
        primary = _pick_last_max(iou[d], reaches & available & ~ignored_row)
        fallback = _pick_last_max(iou[d], reaches & available & ignored_row)
        chosen = np.where(primary >= 0, primary, fallback)
        hit = chosen >= 0
        open_gt[rows[hit], chosen[hit]] = False
        matches[:, d] = chosen
    return matches


class COCOeval:
    def __init__(self, cocoGt=None, cocoDt=None, iouType: str = "segm"):
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.params = Params(iouType)
        self.evalImgs: List = []
        self.eval: Dict = {}
        self.stats = np.zeros(0)
        self.ious: Dict = {}
        if cocoGt is not None:
            self.params.imgIds = sorted(cocoGt.getImgIds())
            self.params.catIds = sorted(cocoGt.getCatIds())

    # ---------------------------------------------------------------- prepare
    def _prepare(self):
        p = self.params
        gts = self.cocoGt.loadAnns(self.cocoGt.getAnnIds(imgIds=p.imgIds, catIds=p.catIds if p.useCats else ()))
        dts = self.cocoDt.loadAnns(self.cocoDt.getAnnIds(imgIds=p.imgIds, catIds=p.catIds if p.useCats else ()))
        if p.iouType == "segm":
            for ann in gts:
                ann["segmentation"] = _to_rle(ann, self.cocoGt)
            for ann in dts:
                ann["segmentation"] = _to_rle(ann, self.cocoDt)
        for gt in gts:
            gt["ignore"] = 1 if gt.get("iscrowd") else 0
            if p.iouType == "keypoints":
                gt["ignore"] = (gt.get("num_keypoints", 0) == 0) or gt["ignore"]
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for gt in gts:
            self._gts[gt["image_id"], gt["category_id"]].append(gt)
        for dt in dts:
            self._dts[dt["image_id"], dt["category_id"]].append(dt)

    def _group(self, table, imgId, catId):
        p = self.params
        if p.useCats:
            return table[imgId, catId]
        return [x for c in p.catIds for x in table[imgId, c]]

    def _sorted_dts(self, imgId, catId):
        dt = self._group(self._dts, imgId, catId)
        order = np.argsort([-d["score"] for d in dt], kind="mergesort")
        return [dt[i] for i in order[: self.params.maxDets[-1]]]

    # --------------------------------------------------------------- evaluate
    def evaluate(self):
        tic = time.time()
        print("Running per image evaluation...")
        p = self.params
        print("Evaluate annotation type *{}*".format(p.iouType))
        p.imgIds = list(np.unique(p.imgIds))
        if p.useCats:
            p.catIds = list(np.unique(p.catIds))
        p.maxDets = sorted(p.maxDets)

        self._prepare()
        catIds = p.catIds if p.useCats else [-1]
        compute = self.computeOks if p.iouType == "keypoints" else self.computeIoU
        self.ious = {(i, c): compute(i, c) for i in p.imgIds for c in catIds}

        # structured result store: records[cat_idx][area_idx] = one entry per
        # image in p.imgIds order (None where the pair has no gts and no dts)
        self._records = [
            [[self._match_image(i, c, r) for i in p.imgIds] for r in p.areaRng]
            for c in catIds
        ]
        # evalImgs keeps the vendored API's flat cat-major ordering for
        # external consumers; accumulate() reads the structured store instead
        self.evalImgs = [rec for per_cat in self._records for per_area in per_cat for rec in per_area]
        self._paramsEval = copy.deepcopy(p)
        print("DONE (t={:0.2f}s).".format(time.time() - tic))

    def computeIoU(self, imgId, catId):
        p = self.params
        gt = self._group(self._gts, imgId, catId)
        dt = self._sorted_dts(imgId, catId)
        if len(gt) == 0 and len(dt) == 0:
            return []
        key = "segmentation" if p.iouType == "segm" else "bbox"
        g = [x[key] for x in gt]
        d = [x[key] for x in dt]
        iscrowd = [int(x.get("iscrowd", 0)) for x in gt]
        return maskUtils.iou(d, g, iscrowd)

    def computeOks(self, imgId, catId):
        """Object-keypoint-similarity matrix [D, G], vectorized over both axes
        (cocoeval.py:193-234 semantics)."""
        gts = self._gts[imgId, catId]
        dts = self._sorted_dts(imgId, catId)
        if len(gts) == 0 or len(dts) == 0:
            return []
        variances = (OKS_SIGMAS * 2) ** 2                        # [K]
        gkp = np.array([g["keypoints"] for g in gts], float).reshape(len(gts), -1, 3)
        dkp = np.array([d["keypoints"] for d in dts], float).reshape(len(dts), -1, 3)
        xg, yg, vg = gkp[..., 0], gkp[..., 1], gkp[..., 2]       # [G, K]
        xd, yd = dkp[..., 0], dkp[..., 1]                        # [D, K]
        visible = vg > 0
        n_vis = visible.sum(axis=1)                              # [G]
        areas = np.array([g["area"] for g in gts], float)
        bbox = np.array([g["bbox"] for g in gts], float)         # [G, 4]

        # visible gts: plain keypoint offsets; label-less gts: distance to a
        # 2x-expanded box around the annotation bbox
        dx_vis = xd[None, :, :] - xg[:, None, :]                 # [G, D, K]
        dy_vis = yd[None, :, :] - yg[:, None, :]
        lo_x, hi_x = bbox[:, 0] - bbox[:, 2], bbox[:, 0] + 2 * bbox[:, 2]
        lo_y, hi_y = bbox[:, 1] - bbox[:, 3], bbox[:, 1] + 2 * bbox[:, 3]
        dx_box = np.maximum(0.0, lo_x[:, None, None] - xd[None, :, :]) + np.maximum(
            0.0, xd[None, :, :] - hi_x[:, None, None]
        )
        dy_box = np.maximum(0.0, lo_y[:, None, None] - yd[None, :, :]) + np.maximum(
            0.0, yd[None, :, :] - hi_y[:, None, None]
        )
        use_vis = (n_vis > 0)[:, None, None]
        dx = np.where(use_vis, dx_vis, dx_box)
        dy = np.where(use_vis, dy_vis, dy_box)
        e = (dx**2 + dy**2) / variances[None, None, :] / (areas[:, None, None] + np.spacing(1)) / 2
        sim = np.exp(-e)                                         # [G, D, K]
        keep = np.where(use_vis, visible[:, None, :], True)
        denom = np.where(n_vis > 0, n_vis, e.shape[-1])[:, None] # [G, 1]
        oks = (sim * keep).sum(axis=-1) / denom                  # [G, D]
        return oks.T                                             # [D, G]

    def _match_image(self, imgId, catId, areaRng) -> Optional[dict]:
        """One (image, category, area-range) record via the vectorized greedy
        matcher; schema matches the vendored evalImgs contract."""
        p = self.params
        gt = self._group(self._gts, imgId, catId)
        dt = self._group(self._dts, imgId, catId)
        if len(gt) == 0 and len(dt) == 0:
            return None
        maxDet = p.maxDets[-1]

        gt_area = np.array([g["area"] for g in gt], float)
        base_ignore = np.array([g["ignore"] for g in gt], bool)
        out_of_range = (gt_area < areaRng[0]) | (gt_area > areaRng[1])
        ignore_flags = (base_ignore | out_of_range).astype(np.int64)
        gt_order = np.argsort(ignore_flags, kind="mergesort")  # non-ignored first
        gt = [gt[i] for i in gt_order]
        ignore_flags = ignore_flags[gt_order]
        crowd_flags = np.array([int(g.get("iscrowd", 0)) for g in gt], np.int64)

        det_order = np.argsort([-d["score"] for d in dt], kind="mergesort")[:maxDet]
        dt = [dt[i] for i in det_order]

        iou = self.ious[imgId, catId]
        iou = np.asarray(iou)[:, gt_order] if len(iou) > 0 else np.zeros((len(dt), len(gt)))

        matches = _greedy_match(iou, ignore_flags, crowd_flags, p.iouThrs)  # [T, D]
        hit = matches >= 0
        safe = np.clip(matches, 0, None)
        gt_id_arr = np.array([g["id"] for g in gt], np.int64)
        det_id_arr = np.array([d["id"] for d in dt], np.int64)
        matched_gt_ids = np.where(hit, gt_id_arr[safe] if len(gt) else 0, 0).astype(float)
        det_ignored = np.where(hit, ignore_flags[safe] if len(gt) else 0, 0).astype(bool)

        # which det claimed each gt (first in score order wins the slot; for
        # crowds several dets can match, the vendored gtm keeps the LAST)
        gt_claimed = np.zeros((len(p.iouThrs), len(gt)))
        for t in range(len(p.iouThrs)):
            idx = matches[t][hit[t]]
            gt_claimed[t, idx] = det_id_arr[hit[t]]

        det_area = np.array([d["area"] for d in dt], float)
        det_out = (det_area < areaRng[0]) | (det_area > areaRng[1])
        det_ignored = det_ignored | (~hit & det_out[None, :])
        return {
            "image_id": imgId,
            "category_id": catId,
            "aRng": areaRng,
            "maxDet": maxDet,
            "dtIds": det_id_arr.tolist(),
            "gtIds": gt_id_arr.tolist(),
            "dtMatches": matched_gt_ids,
            "gtMatches": gt_claimed,
            "dtScores": [d["score"] for d in dt],
            "gtIgnore": ignore_flags,
            "dtIgnore": det_ignored,
        }

    # -------------------------------------------------------------- accumulate
    def accumulate(self, p=None):
        """Batched precision/recall accumulation over the structured record
        store — cumsum + envelope + searchsorted, all [T, N] at once."""
        print("Accumulating evaluation results...")
        tic = time.time()
        if p is None:
            p = self.params
        p.catIds = p.catIds if p.useCats == 1 else [-1]
        n_thr, n_rec = len(p.iouThrs), len(p.recThrs)
        n_cat = len(p.catIds) if p.useCats else 1
        n_area, n_cap = len(p.areaRng), len(p.maxDets)
        precision = -np.ones((n_thr, n_rec, n_cat, n_area, n_cap))
        recall = -np.ones((n_thr, n_cat, n_area, n_cap))
        scores = -np.ones((n_thr, n_rec, n_cat, n_area, n_cap))

        for ci in range(n_cat):
            for ai in range(n_area):
                recs = [r for r in self._records[ci][ai] if r is not None]
                if not recs:
                    continue
                n_pos = int(sum(np.count_nonzero(np.asarray(r["gtIgnore"]) == 0) for r in recs))
                if n_pos == 0:
                    continue
                for mi, cap in enumerate(p.maxDets):
                    det_scores = np.concatenate([np.asarray(r["dtScores"][:cap]) for r in recs])
                    order = np.argsort(-det_scores, kind="mergesort")
                    det_scores = det_scores[order]
                    matched = np.concatenate(
                        [np.asarray(r["dtMatches"])[:, :cap] for r in recs], axis=1
                    )[:, order] != 0
                    ignored = np.concatenate(
                        [np.asarray(r["dtIgnore"])[:, :cap] for r in recs], axis=1
                    )[:, order].astype(bool)
                    counted = ~ignored
                    hits = np.cumsum(matched & counted, axis=1).astype(np.float64)   # [T, N]
                    misses = np.cumsum(~matched & counted, axis=1).astype(np.float64)
                    n_det = hits.shape[1]
                    rc = hits / n_pos
                    pr = hits / (misses + hits + np.spacing(1))
                    recall[:, ci, ai, mi] = rc[:, -1] if n_det else 0
                    # monotone precision envelope: running max from the right
                    envelope = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
                    for t in range(n_thr):
                        at = np.searchsorted(rc[t], p.recThrs, side="left")
                        ok = at < n_det
                        q = np.zeros(n_rec)
                        s = np.zeros(n_rec)
                        q[ok] = envelope[t, at[ok]]
                        s[ok] = det_scores[at[ok]]
                        precision[t, :, ci, ai, mi] = q
                        scores[t, :, ci, ai, mi] = s
        self.eval = {
            "params": p,
            "counts": [n_thr, n_rec, n_cat, n_area, n_cap],
            "date": datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
            "precision": precision,
            "recall": recall,
            "scores": scores,
        }
        print("DONE (t={:0.2f}s).".format(time.time() - tic))

    # --------------------------------------------------------------- summarize
    def summarize(self):
        def _summ(ap=1, iouThr=None, areaRng="all", maxDets=100):
            p = self.params
            iStr = " {:<18} {} @[ IoU={:<9} | area={:>6s} | maxDets={:>3d} ] = {:0.3f}"
            titleStr = "Average Precision" if ap == 1 else "Average Recall"
            typeStr = "(AP)" if ap == 1 else "(AR)"
            iouStr = (
                "{:0.2f}:{:0.2f}".format(p.iouThrs[0], p.iouThrs[-1])
                if iouThr is None
                else "{:0.2f}".format(iouThr)
            )
            aind = [i for i, a in enumerate(p.areaRngLbl) if a == areaRng]
            mind = [i for i, m in enumerate(p.maxDets) if m == maxDets]
            s = self.eval["precision"] if ap == 1 else self.eval["recall"]
            if iouThr is not None:
                s = s[np.where(iouThr == p.iouThrs)[0]]
            s = s[..., aind, mind] if ap == 0 else s[:, :, :, aind, mind]
            mean_s = -1 if len(s[s > -1]) == 0 else np.mean(s[s > -1])
            print(iStr.format(titleStr, typeStr, iouStr, areaRng, maxDets, mean_s))
            return mean_s

        if not self.eval:
            raise Exception("Please run accumulate() first")
        if self.params.iouType == "keypoints":
            md = self.params.maxDets[0]
            self.stats = np.array(
                [
                    _summ(1, maxDets=md), _summ(1, maxDets=md, iouThr=.5),
                    _summ(1, maxDets=md, iouThr=.75), _summ(1, maxDets=md, areaRng="medium"),
                    _summ(1, maxDets=md, areaRng="large"), _summ(0, maxDets=md),
                    _summ(0, maxDets=md, iouThr=.5), _summ(0, maxDets=md, iouThr=.75),
                    _summ(0, maxDets=md, areaRng="medium"), _summ(0, maxDets=md, areaRng="large"),
                ]
            )
        else:
            m = self.params.maxDets
            self.stats = np.array(
                [
                    _summ(1), _summ(1, iouThr=.5, maxDets=m[2]), _summ(1, iouThr=.75, maxDets=m[2]),
                    _summ(1, areaRng="small", maxDets=m[2]), _summ(1, areaRng="medium", maxDets=m[2]),
                    _summ(1, areaRng="large", maxDets=m[2]), _summ(0, maxDets=m[0]),
                    _summ(0, maxDets=m[1]), _summ(0, maxDets=m[2]),
                    _summ(0, areaRng="small", maxDets=m[2]), _summ(0, areaRng="medium", maxDets=m[2]),
                    _summ(0, areaRng="large", maxDets=m[2]),
                ]
            )
        return self.stats

    def __str__(self):
        # reference quirk kept: printing a COCOeval runs summarize()
        # (cocoeval.py:496-497)
        self.summarize()
        return ""


def _to_rle(ann: dict, coco) -> dict:
    segm = ann["segmentation"]
    if isinstance(segm, dict) and not isinstance(segm.get("counts"), list):
        return segm
    return coco.annToRLE(ann)
