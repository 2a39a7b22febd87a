"""The PyTorch port's COCO detection/segmentation API against the JAX
package's: COCOeval (bbox, segm, keypoints), the native RLE mask library,
the columnar JSON scanner and the vocab stage's fast path, the v1.0.1
legacy COCO, the rest of the COCO API (masks, segmentation results, numpy
annotations, drawing, download) and download.sh. Both packages run the
same numpy code on their own copies of the C++ libraries, so every result
is compared with == or np.array_equal (NaN and -1 in the same places)."""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import textwrap
import threading
import zipfile
from functools import partial
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from adaptive_tpu.data import coco_api as JAPI
from adaptive_tpu.data import coco_legacy as JLEG
from adaptive_tpu.data import fast_json as JFJ
from adaptive_tpu.evalcap import detection as JDET
from adaptive_tpu.native import mask as JM
from adaptive_tpu_torch.data import coco_api as TAPI
from adaptive_tpu_torch.data import coco_legacy as TLEG
from adaptive_tpu_torch.data import fast_json as TFJ
from adaptive_tpu_torch.evalcap import detection as TDET
from adaptive_tpu_torch.native import build as TBUILD
from adaptive_tpu_torch.native import mask as TM
from tests.test_detection_eval import _synthetic_det_dataset
from tests.torch_port_util import port_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(a, b, where="") -> None:
    """Recursive equality: dict keys and values, sequences, ndarrays by
    dtype, shape and np.array_equal (NaN equal to NaN)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (where, a, b)


# ------------------------------------------------------------------ COCOeval
def _keypoint_dataset(tmp_path):
    """tests/test_detection_eval.py::test_keypoints_ap_matches_reference's
    two images of two people with jittered detections."""
    rng = np.random.default_rng(1)
    images = [{"id": 1, "height": 200, "width": 200}, {"id": 2, "height": 200, "width": 200}]
    gts, dts, aid = [], [], 1
    for img in images:
        for _ in range(2):
            base = rng.uniform(40, 140, 2)
            kps = []
            for _ in range(17):
                kps.extend([float(base[0] + rng.normal(0, 15)),
                            float(base[1] + rng.normal(0, 15)), 2])
            gts.append({"id": aid, "image_id": img["id"], "category_id": 1, "keypoints": kps,
                        "num_keypoints": 17, "area": 3600.0, "iscrowd": 0,
                        "bbox": [float(base[0] - 30), float(base[1] - 30), 60.0, 60.0]})
            aid += 1
            dkps = list(kps)
            for i in range(0, len(dkps), 3):
                dkps[i] += float(rng.normal(0, 5))
                dkps[i + 1] += float(rng.normal(0, 5))
            dts.append({"image_id": img["id"], "category_id": 1, "keypoints": dkps,
                        "score": float(rng.random())})
    p = tmp_path / "gt_kp.json"
    p.write_text(json.dumps({"images": images, "annotations": gts,
                             "categories": [{"id": 1, "name": "person"}]}))
    return str(p), dts


def _run_eval(api, det, gt_path, dts, iou_type, capsys):
    gt = api.COCO(gt_path)
    ev = det.COCOeval(gt, gt.loadRes([dict(d) for d in dts]), iou_type)
    ev.evaluate()
    ev.accumulate()
    capsys.readouterr()
    stats = ev.summarize()
    return ev, stats, capsys.readouterr().out


FUZZ = [(7, 6, 3), (11, 2, 1), (13, 8, 4)]  # tests/test_detection_eval.py's shapes


@pytest.mark.parametrize("iou_type,seed,n_imgs,n_cats",
                         [(t, *f) for t in ("bbox", "segm") for f in FUZZ]
                         + [("keypoints", 1, 2, 1)])
def test_cocoeval_equals_jax(tmp_path, capsys, iou_type, seed, n_imgs, n_cats):
    """evalImgs, precision, recall, scores, stats and the summarize text
    equal JAX's on test_detection_eval.py's fuzz shapes (crowds among the
    ground truths; segm from the boxes' polygons) and on its keypoint set."""
    if iou_type == "keypoints":
        gt_path, dts = _keypoint_dataset(tmp_path)
    else:
        gt_path, dts = _synthetic_det_dataset(tmp_path, seed=seed, n_imgs=n_imgs, n_cats=n_cats)
        if iou_type == "segm":
            for d in dts:
                x, y, w, h = d["bbox"]
                d["segmentation"] = [[x, y, x, y + h, x + w, y + h, x + w, y]]
    jev, jstats, jtext = _run_eval(JAPI, JDET, gt_path, dts, iou_type, capsys)
    tev, tstats, ttext = _run_eval(TAPI, TDET, gt_path, dts, iou_type, capsys)
    assert len(tev.evalImgs) == len(jev.evalImgs) > 0
    _same(tev.evalImgs, jev.evalImgs, "evalImgs")
    for k in ("precision", "recall", "scores", "counts"):
        _same(tev.eval[k], jev.eval[k], k)
    _same(tstats, jstats, "stats")
    assert ttext == jtext and "Average Precision" in ttext
    assert (tstats >= 0).any()


def test_cocoeval_params_and_helpers_equal_jax():
    """Params per type, OKS_SIGMAS, _pick_last_max and _greedy_match on
    seeded matrices equal JAX's."""
    for t in ("bbox", "segm", "keypoints"):
        _same(vars(TDET.Params(t)), vars(JDET.Params(t)), t)
    _same(TDET.OKS_SIGMAS, JDET.OKS_SIGMAS)
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 4, 7).astype(np.float64)
    elig = rng.random((10, 7)) < 0.6
    _same(TDET._pick_last_max(vals, elig), JDET._pick_last_max(vals, elig))
    import inspect

    assert inspect.signature(TDET._greedy_match) == inspect.signature(JDET._greedy_match)


# ------------------------------------------------------------- mask library
def _random_mask(rng, h, w, blobs=3):
    m = np.zeros((h, w), np.uint8)
    for _ in range(blobs):
        y, x = rng.integers(0, h), rng.integers(0, w)
        hh, ww = rng.integers(1, h // 2 + 1), rng.integers(1, w // 2 + 1)
        m[y:y + hh, x:x + ww] = 1
    return m


def _mask_calls(M):
    """tests/test_mask.py's first five tests' calls, with their outputs."""
    rng = np.random.default_rng(0)
    out = {"roundtrip": []}
    for _ in range(10):
        rle = M.encode(_random_mask(rng, 37, 23))
        out["roundtrip"].append((rle, M.decode(rle)))
    m = np.zeros((10, 12), np.uint8)
    m[2:5, 3:8] = 1
    out["area_bbox"] = (M.area(M.encode(m)), M.toBbox(M.encode(m)))
    a, b = np.zeros((8, 8), np.uint8), np.zeros((8, 8), np.uint8)
    a[0:4], b[2:6] = 1, 1
    out["merge"] = [M.merge([M.encode(a), M.encode(b)], intersect=i) for i in (False, True)]
    a, b = np.zeros((10, 10), np.uint8), np.zeros((10, 10), np.uint8)
    a[0:5], b[3:8] = 1, 1
    out["iou"] = [M.iou([M.encode(a)], [M.encode(b)], [c]) for c in (0, 1)]
    out["iou_bbox"] = M.iou([[0, 0, 4, 4]], [[2, 2, 4, 4]], [0])
    sq = [1.0, 1.0, 1.0, 6.0, 6.0, 6.0, 6.0, 1.0]
    out["poly"] = M.frPyObjects([sq], 10, 10)
    out["poly_flat"] = M.frPyObjects(sq, 10, 10)
    out["box"] = M.frPyObjects([[2, 3, 4, 5]], 10, 10)
    out["decoded"] = M.decode(out["poly"] + out["box"])
    out["areas"] = M.area(out["poly"] + out["box"])
    good = M.encode(np.ones((4, 4), np.uint8))
    out["corrupt"] = M.decode({"size": [2, 2], "counts": good["counts"]})
    return out


def test_mask_library_equals_jax():
    """encode/decode, area, toBbox, merge, iou (RLE, crowd, boxes),
    frPyObjects (polygons, flat polygon, boxes), a list decode, and the
    bounded decode of corrupt counts equal JAX's."""
    got, want = _mask_calls(TM), _mask_calls(JM)
    _same(got, want, "mask")
    assert got["corrupt"].shape == (2, 2)


def test_iou_with_an_empty_side_and_cocoeval_there():
    """An (image, category) with ground truths and no detections (or the
    reverse): the port's iou gives an empty [len(dt), len(gt)] matrix, as
    pycocotools gives no IoUs (_mask.pyx iou), where JAX's copy sends an
    empty dt with boxes down its RLE path and raises TypeError. With JAX's
    iou given that one rule, COCOeval on a set with such pairs equals JAX's
    (==)."""
    boxes = [[0, 0, 4, 4], [2, 2, 4, 4]]
    rle = TM.encode(np.ones((4, 4), np.uint8))
    for dt, gt in (([], boxes), (boxes, []), ([], [rle]), ([rle], [])):
        assert TM.iou(dt, gt, [0] * len(gt)).shape == (len(dt), len(gt))
    with pytest.raises(TypeError):
        JM.iou([], boxes, [0, 0])


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_cocoeval_with_unmatched_pairs_equals_jax(tmp_path, capsys, monkeypatch, iou_type):
    """The fuzz set of seed 7 with a fifth of the detections moved to
    another category (pairs with ground truths and no detection, and the
    reverse): evalImgs, precision, recall, scores and stats equal JAX's,
    JAX's iou patched to return the empty matrix where a side is empty."""
    orig = JM.iou
    monkeypatch.setattr(JDET.maskUtils, "iou", lambda d, g, c: np.zeros((len(d), len(g)))
                        if len(d) == 0 or len(g) == 0 else orig(d, g, c))
    gt_path, dts = _synthetic_det_dataset(tmp_path, seed=7, n_imgs=6, n_cats=3)
    rng = np.random.default_rng(2)
    for d in dts:
        if rng.random() < 0.2:
            d["category_id"] = 4  # no ground truth of category 4; its own come unmatched
        if iou_type == "segm":
            x, y, w, h = d["bbox"]
            d["segmentation"] = [[x, y, x, y + h, x + w, y + h, x + w, y]]
    doc = json.loads(open(gt_path).read())
    doc["categories"].append({"id": 4, "name": "cat4", "supercategory": "x"})
    with open(gt_path, "w") as f:
        json.dump(doc, f)
    jev, jstats, jtext = _run_eval(JAPI, JDET, gt_path, dts, iou_type, capsys)
    tev, tstats, ttext = _run_eval(TAPI, TDET, gt_path, dts, iou_type, capsys)
    _same(tev.evalImgs, jev.evalImgs, "evalImgs")
    for k in ("precision", "recall", "scores"):
        _same(tev.eval[k], jev.eval[k], k)
    _same(tstats, jstats, "stats")
    assert ttext == jtext


# ---------------------------------------------------------------- fast_json
def _basic_doc():
    return {
        "info": {"year": 2014, "nested": {"a": [1, 2, {"b": None}], "ok": True}},
        "images": [{"id": 7, "file_name": "a.jpg", "height": 480, "width": 640},
                   {"id": 9, "file_name": "dir/b.png"}],
        "annotations": [
            {"id": 1, "image_id": 7, "caption": "a man riding a horse ."},
            {"id": 2, "image_id": 9, "caption": 'quotes " backslash \\ slash / tab\t.'},
            {"id": 3, "image_id": 9, "caption": "unicode café ☃ \U0001F600"},
            {"id": 4, "image_id": 9, "caption": "\" \\ / \b \f \n \r \t Aß東\U0001F680"},
            {"id": 5, "image_id": 7, "category_id": 2, "bbox": [0, 0, 2, 2], "area": 4.0},
        ],
        "categories": [{"id": 4, "name": "animal", "supercategory": "x"}],
    }


JSON_CASES = {
    "basic": json.dumps(_basic_doc()),
    "numbers": ('{"junk": [1e3, -2.5E-2, [[[{"x": null}]]], false], "annotations": '
                '[{"id": 1.0, "image_id": 4.2e1, "caption": "hi", "extra": {"deep": '
                '[1, {"q": "\\u0041"}]}}], "images": []}'),
    "deep": '{"junk": ' + "[" * 200_000 + "]" * 200_000 + ', "annotations": [], "images": []}',
    "moderate": '{"junk": ' + "[" * 100 + "]" * 100 + ', "annotations": [], "images": []}',
    "image_info": '{"images": [{"id": 1, "file_name": "a.jpg"}]}',
    "lone_low_surrogate": '{"images": [], "annotations": [{"id": 1, "image_id": 1, '
                          '"caption": "\\udc00"}]}',
    **{f"malformed_{i}": bad for i, bad in enumerate(
        ['{"annotations": [{]}', "[1,2,3]", '{"a": 1} trailing', "{} trailing", "{", ""])},
    **{f"non_coco_{i}": doc for i, doc in enumerate(['{"foo": 1}', "{}",
                                                     '{"categories": []}'])},
}


@pytest.mark.parametrize("case", sorted(JSON_CASES))
def test_fast_json_equals_jax(tmp_path, case):
    """load_columns and load_captions equal JAX's on COCO documents
    (escapes, surrogate pairs, number forms, detection annotations), and
    return None where JAX's do (malformed, too deep, a lone low surrogate,
    JSON that is not COCO)."""
    p = tmp_path / "ann.json"
    p.write_text(JSON_CASES[case], encoding="utf-8")
    got, want = TFJ.load_columns(str(p)), JFJ.load_columns(str(p))
    assert (got is None) == (want is None)
    if want is not None:
        _same(vars(got), vars(want), case)
    _same(TFJ.load_captions(str(p)), JFJ.load_captions(str(p)), case)
    if case in ("basic", "numbers", "moderate", "image_info"):
        assert got is not None
    assert TFJ.load_columns(str(tmp_path / "missing.json")) is None


def test_vocab_stage_reads_fast_json_and_equals_jax(tmp_path, monkeypatch):
    """main_build_vocab reads the captions through the port's fast_json
    (not the COCO API) and writes a vocab.json equal (==) to JAX's."""
    from adaptive_tpu.config import load_config as jload
    from adaptive_tpu.data.vocab import main_build_vocab as jbuild
    from adaptive_tpu_torch.config import load_config as tload
    from adaptive_tpu_torch.data import coco_api as tcoco
    from adaptive_tpu_torch.data.vocab import main_build_vocab as tbuild

    rng = np.random.default_rng(4)
    words = ["a", "dog", "cat", "runs", "sits", "on", "the", "mat", "café"]
    doc = {"images": [{"id": i, "file_name": f"{i}.jpg"} for i in range(20)],
           "annotations": [{"id": i, "image_id": i % 20,
                            "caption": " ".join(rng.choice(words, 6))} for i in range(60)]}
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps(doc))
    read = []
    orig = TFJ.load_captions
    monkeypatch.setattr(TFJ, "load_captions", lambda p: read.append(p) or orig(p))
    monkeypatch.setattr(tcoco, "COCO", None)  # the fallback must not run
    tv = tbuild(tload(None, train_anno_path=str(ann), vocab_threshold=2,
                      vocab_path=str(tmp_path / "t.json")))
    jbuild(jload(None, train_anno_path=str(ann), vocab_threshold=2,
                 vocab_path=str(tmp_path / "j.json")))
    assert read == [str(ann)] and len(tv) > 4
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()


# --------------------------------------------------------------- coco_legacy
def _legacy_docs():
    caps = {"info": {"year": 2014, "description": "tiny"}, "type": "captions",
            "licenses": [{"id": 1}],
            "images": [{"id": 1, "file_name": "a.jpg"}, {"id": 2, "file_name": "b.jpg"}],
            "annotations": [{"id": 10, "image_id": 1, "caption": "a cat"},
                            {"id": 11, "image_id": 1, "caption": "a dog"},
                            {"id": 12, "image_id": 2, "caption": "a bird"}]}
    inst = {"info": {"year": 2014}, "type": "instances", "licenses": [],
            "images": [{"id": 1, "file_name": "a.jpg"}, {"id": 2, "file_name": "b.jpg"}],
            "annotations": [
                {"id": 1, "image_id": 1, "category_id": 1, "area": 10.0, "iscrowd": 0},
                {"id": 2, "image_id": 2, "category_id": 2, "area": 99.0, "iscrowd": 1}],
            "categories": [{"id": 1, "name": "cat", "supercategory": "animal"},
                           {"id": 2, "name": "car", "supercategory": "vehicle"}]}
    return caps, inst


def _legacy_calls(cls, tmp_path, tag):
    caps, inst = _legacy_docs()
    out = {}
    for doc in (caps, inst):
        p = tmp_path / f"{tag}_{doc['type']}.json"
        p.write_text(json.dumps(doc))
        c = cls(str(p))
        r = {"imgs": sorted(c.getImgIds()), "anns": c.getAnnIds(),
             "anns1": c.getAnnIds(imgIds=1), "img1": c.loadImgs(1), "index": c.imgToAnns,
             "cats": c.cats, "catToImgs": c.catToImgs, "loadAnns": c.loadAnns([10, 11])
             if doc is caps else c.loadAnns(1)}
        if doc is inst:
            r.update(sup=c.getCatIds(supNms=["animal"]), crowd=c.getAnnIds(iscrowd=1),
                     area=c.getAnnIds(areaRng=[5, 50]), cat2=sorted(c.getImgIds(catIds=[2])),
                     loadCats=c.loadCats([1, 2]))
        out[doc["type"]] = r
    rng = np.random.default_rng(0)
    codec = []
    for shape in [(7, 5), (1, 9), (12, 12), (3, 3)]:
        m = (rng.random(shape) < 0.4).astype(np.uint8) if shape != (3, 3) else np.ones(shape)
        r = cls.encodeMask(m)
        codec.append((r, cls.decodeMask(r)))
    out["codec"] = codec
    rp = tmp_path / f"{tag}_res.json"
    rp.write_text(json.dumps([{"image_id": 1, "caption": "hello"},
                              {"image_id": 2, "caption": "world"}]))
    p = tmp_path / f"{tag}_captions.json"
    res = cls(str(p)).loadRes(str(rp))
    out["loadRes"] = (sorted(res.anns), res.anns, res.dataset["images"])
    p = tmp_path / f"{tag}_instances.json"
    for kind, anns in (("bbox", [{"image_id": 1, "category_id": 1, "bbox": [1, 2, 3, 4],
                                  "score": 0.5}]),
                       ("segm", [{"image_id": 2, "category_id": 2, "score": 0.1,
                                  "segmentation": {"size": [4, 4],
                                                   "counts": [3, 5, 2, 6]}}])):
        rp.write_text(json.dumps(anns))
        out[f"loadRes_{kind}"] = cls(str(p)).loadRes(str(rp)).anns
    out["segToMask"] = cls.segToMask([[2.0, 2.0, 2.0, 8.0, 8.0, 8.0, 8.0, 2.0]], 10, 10)
    c = cls()
    c.dataset = {"info": {"year": 2014, "description": "tiny"}}
    c.info()
    return out


def test_coco_legacy_equals_jax(tmp_path, capsys):
    """The v1.0.1 COCO: index, getters, the uncompressed mask codec (the
    leading-zero quirk), loadRes ids from 0 (captions, boxes, segments),
    segToMask and info equal JAX's, printed lines too."""
    got = _legacy_calls(TLEG.COCO, tmp_path, "t")
    tout = capsys.readouterr().out
    want = _legacy_calls(JLEG.COCO, tmp_path, "j")
    jout = capsys.readouterr().out
    _same(got, want, "legacy")
    assert tout == jout and "description: tiny" in tout
    assert got["codec"][-1][0]["counts"][0] == 0 and sorted(got["loadRes"][0]) == [0, 1]
    assert got["segToMask"].dtype == bool and got["segToMask"][4, 4]


# ---------------------------------------------------------------- coco_api
def _api_doc():
    rng = np.random.default_rng(5)
    m = np.zeros((12, 16), np.uint8)
    m[3:9, 4:11] = 1
    flat = m.ravel(order="F")
    counts, v, run = [], 0, 0
    for px in flat:
        if px != v:
            counts.append(run)
            v, run = px, 0
        run += 1
    counts.append(run)
    compressed = JM.encode(np.asfortranarray(m))
    compressed = {"size": compressed["size"], "counts": compressed["counts"].decode()}
    kps = [float(v) for i in range(5) for v in (rng.uniform(0, 15), rng.uniform(0, 11), 2)]
    return {
        "images": [{"id": 1, "file_name": "a.jpg", "height": 12, "width": 16},
                   {"id": 2, "file_name": "b.jpg", "height": 12, "width": 16}],
        "annotations": [
            {"id": 1, "image_id": 1, "category_id": 1, "iscrowd": 0, "area": 20.0,
             "segmentation": [[1, 1, 1, 6, 6, 6, 6, 1], [8, 2, 14, 2, 11, 9]],
             "bbox": [1, 1, 13, 8]},
            {"id": 2, "image_id": 2, "category_id": 1, "iscrowd": 1, "area": 42.0,
             "segmentation": {"size": [12, 16], "counts": counts}, "bbox": [4, 3, 7, 6]},
            {"id": 3, "image_id": 2, "category_id": 2, "iscrowd": 0, "area": 42.0,
             "segmentation": compressed, "bbox": [4, 3, 7, 6], "keypoints": kps,
             "num_keypoints": 5},
        ],
        "categories": [{"id": 1, "name": "thing"},
                       {"id": 2, "name": "person", "skeleton": [[1, 2], [2, 3], [4, 5]]}],
    }


def _api_calls(api, path):
    c = api.COCO(path)
    out = {"rle": [c.annToRLE(a) for a in c.loadAnns([1, 2, 3])],
           "mask": [c.annToMask(a) for a in c.loadAnns([1, 2, 3])]}
    seg = [{"image_id": 2, "category_id": 1, "score": 0.7,
            "segmentation": out["rle"][0]},
           {"image_id": 1, "category_id": 2, "score": 0.2, "bbox": [0, 0, 3, 3],
            "segmentation": out["rle"][2]}]
    res = c.loadRes(seg)
    out["loadRes_segm"] = (res.anns, res.dataset["categories"])
    kp = [{"image_id": 1, "category_id": 2, "score": 0.9, "keypoints": [2, 3, 2, 9, 1, 2, 5, 7, 1]}]
    out["loadRes_kp"] = c.loadRes(kp).anns
    rows = np.array([[1, 10.0, 20.0, 30.0, 40.0, 0.9, 3], [2, 0.0, 0.0, 5.0, 5.0, 0.5, 7]])
    out["numpy"] = c.loadNumpyAnnotations(rows)
    with pytest.raises(AssertionError):
        c.loadNumpyAnnotations(np.zeros((2, 6)))
    return c, out


def test_coco_api_masks_and_results_equal_jax(tmp_path):
    """annToRLE and annToMask on a polygon pair, an uncompressed and a
    compressed RLE; loadRes of segmentation results (area and bbox from the
    mask library) and of keypoints; loadNumpyAnnotations: equal to JAX's."""
    p = tmp_path / "ann.json"
    p.write_text(json.dumps(_api_doc()))
    _, got = _api_calls(TAPI, str(p))
    _, want = _api_calls(JAPI, str(p))
    _same(got, want, "coco_api")
    assert got["mask"][1].sum() == 42 and got["loadRes_segm"][0][1]["area"] > 0


def test_show_anns_equals_jax(tmp_path, capsys):
    """showAnns under matplotlib's Agg backend draws what JAX's draws (the
    same polygons, mask overlays and keypoint lines, tints from the same
    np.random draws), and prints captions as JAX's."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    p = tmp_path / "ann.json"
    p.write_text(json.dumps(_api_doc()))
    drawn = []
    for api in (TAPI, JAPI):
        c = api.COCO(str(p))
        np.random.seed(0)
        fig = plt.figure()
        try:
            assert c.showAnns([]) == 0
            c.showAnns(c.loadAnns([1, 2, 3]))
            ax = plt.gca()
            drawn.append({
                "paths": [[pp.vertices for pp in col.get_paths()] for col in ax.collections],
                "faces": [np.asarray(col.get_facecolor()) for col in ax.collections],
                "images": [np.asarray(im.get_array()) for im in ax.images],
                "lines": [(ln.get_xydata(), ln.get_color() if isinstance(ln.get_color(), str)
                           else tuple(ln.get_color())) for ln in ax.lines]})
        finally:
            plt.close(fig)
        cap = api.COCO()
        cap.dataset = {"images": [{"id": 1}], "annotations": [
            {"id": 1, "image_id": 1, "caption": "a dog"}]}
        cap.createIndex()
        cap.showAnns(cap.loadAnns([1]))
    _same(drawn[0], drawn[1], "showAnns")
    assert len(drawn[0]["paths"]) == 2 and len(drawn[0]["images"]) == 2 and drawn[0]["lines"]
    assert capsys.readouterr().out.count("a dog") == 2


# ------------------------------------------------------------------ download
@pytest.fixture()
def fixture_server(tmp_path):
    """A localhost http.server over tmp_path/srv; yields (root, base url)."""
    root = tmp_path / "srv"
    root.mkdir()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                partial(SimpleHTTPRequestHandler, directory=str(root)))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield root, f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()


def _download_coco(api, base):
    c = api.COCO()
    c.dataset = {"images": [{"id": i, "file_name": f"{i}.jpg", "coco_url": f"{base}/{i}.jpg"}
                            for i in (1, 2, 3)], "annotations": []}
    c.createIndex()
    return c


def test_download_equals_jax(fixture_server, tmp_path, capsys):
    """download fetches each image by its coco_url from a localhost server,
    skips files already there, honours imgIds, and returns -1 without a
    target, as JAX's does: the same files and the same printed lines."""
    root, base = fixture_server
    for i in (1, 2, 3):
        (root / f"{i}.jpg").write_bytes(bytes([i]) * (100 + i))
    lines = []
    for api in (TAPI, JAPI):
        c = _download_coco(api, base)
        out = tmp_path / api.__name__.split(".")[0]
        out.mkdir()
        (out / "2.jpg").write_bytes(b"kept")
        capsys.readouterr()
        assert c.download() == -1
        c.download(str(out), imgIds=[1, 2])
        assert (out / "1.jpg").read_bytes() == bytes([1]) * 101
        assert (out / "2.jpg").read_bytes() == b"kept" and not (out / "3.jpg").exists()
        c.download(str(out))
        assert (out / "3.jpg").read_bytes() == bytes([3]) * 103
        text = capsys.readouterr().out
        lines.append([ln.split(" (t=")[0] for ln in text.splitlines()])
    assert lines[0] == lines[1] and lines[0][0] == "Please specify target directory"


def test_download_script_equals_jax(fixture_server, tmp_path):
    """The port's download.sh is JAX's, and run against the fixture server
    through the COCO_*_URL overrides (as tests/test_data_stages.py runs
    JAX's) it lays out the annotations and image dirs and removes the
    archives."""
    if not (shutil.which("wget") and shutil.which("unzip")):
        pytest.skip("wget/unzip not installed")
    script = os.path.join(REPO, "adaptive_tpu_torch", "data", "download.sh")
    with open(script) as f, open(os.path.join(REPO, "adaptive_tpu", "data", "download.sh")) as g:
        ours = [ln for ln in f if not ln.startswith("#")]
        assert ours == [ln for ln in g if not ln.startswith("#")]
    root, base = fixture_server
    (root / "zips").mkdir()
    (root / "annotations").mkdir()
    anno = json.dumps({"images": [], "annotations": [], "type": "captions"})
    for path, members in (
            (root / "annotations" / "annotations_trainval2014.zip",
             {"annotations/captions_train2014.json": anno,
              "annotations/captions_val2014.json": anno}),
            (root / "zips" / "train2014.zip",
             {"train2014/COCO_train2014_000000000001.jpg": b"\xff\xd8fake"}),
            (root / "zips" / "val2014.zip",
             {"val2014/COCO_val2014_000000000002.jpg": b"\xff\xd8fake"})):
        with zipfile.ZipFile(path, "w") as z:
            for name, payload in members.items():
                z.writestr(name, payload)
    target = tmp_path / "MSCOCO"
    env = dict(os.environ, COCO_IMAGES_URL=f"{base}/zips",
               COCO_ANNOTATIONS_URL=f"{base}/annotations")
    proc = subprocess.run(["bash", script, str(target)], env=env, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    ann = target / "annotations" / "annotations"
    assert json.loads((ann / "captions_val2014.json").read_text())["type"] == "captions"
    assert (ann / "captions_train2014.json").exists()
    assert (target / "train2014" / "COCO_train2014_000000000001.jpg").exists()
    assert (target / "val2014" / "COCO_val2014_000000000002.jpg").exists()
    assert not list(target.glob("*.zip"))


# -------------------------------------------------------------------- builds
def test_native_libraries_build_lazily_under_the_port():
    """In a fresh process, importing the port's native, fast_json,
    coco_api, coco_legacy and detection modules builds and loads nothing;
    the first calls build both libraries under adaptive_tpu_torch/native/
    build/ (named by their sources' hash) and load those, never the JAX
    package's libmask.so or libcocojson.so."""
    code = textwrap.dedent("""
        import ctypes, json, sys, tempfile
        from adaptive_tpu_torch.native import build
        built = []
        orig = build._build
        build._build = lambda src, force: built.append(src.name) or orig(src, force)
        opened = []
        cdll = ctypes.CDLL
        ctypes.CDLL = lambda name, *a, **k: opened.append(str(name)) or cdll(name, *a, **k)
        import adaptive_tpu_torch.native
        from adaptive_tpu_torch.native import mask
        from adaptive_tpu_torch.data import coco_api, coco_legacy, fast_json
        from adaptive_tpu_torch.evalcap import detection
        assert built == [] and opened == [] and mask._L is None, (built, opened)
        import numpy as np
        assert mask.area(mask.encode(np.ones((3, 2), np.uint8))) == 6
        with tempfile.NamedTemporaryFile("w", suffix=".json") as f:
            json.dump({"images": [], "annotations": [{"id": 1, "image_id": 1,
                                                      "caption": "x"}]}, f)
            f.flush()
            assert fast_json.load_captions(f.name) == ["x"]
        print(json.dumps({"built": built, "opened": opened,
                          "mask": str(build.library_path(build.SRC)),
                          "json": str(build.library_path(build.JSON_SRC))}))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    build_dir = os.path.join(REPO, "adaptive_tpu_torch", "native", "build")
    assert out["built"] == ["masklib.cpp", "jsonlib.cpp"]
    assert out["opened"] == [out["mask"], out["json"]]
    for lib in out["opened"]:
        assert os.path.dirname(lib) == build_dir and os.path.exists(lib)
    assert str(TBUILD.BUILD_DIR) == build_dir
    assert ctypes.CDLL(TBUILD.ensure_built())  # rebuilds nothing: the same path


def test_package_data_ships_the_native_sources_and_download_script():
    """pyproject.toml's package-data names the C++ sources the libraries
    build from at first use, and download.sh, so an installed port has
    them."""
    tomllib = pytest.importorskip("tomllib")  # Python 3.11 and later
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    shipped = {p.name for pat in data["adaptive_tpu_torch.native"]
               for p in TBUILD.HERE.glob(pat)}
    assert shipped == {"masklib.cpp", "jsonlib.cpp"} == {TBUILD.SRC.name, TBUILD.JSON_SRC.name}
    data_dir = os.path.join(REPO, "adaptive_tpu_torch", "data")
    assert data["adaptive_tpu_torch.data"] == ["download.sh"]
    assert os.path.exists(os.path.join(data_dir, "download.sh"))
