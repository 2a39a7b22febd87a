"""Columnar COCO-annotation loading via the native jsonlib (ctypes bridge;
counterpart of adaptive_tpu/data/fast_json.py).

Capability parity with the reference's vendored gason C++ JSON parser
(coco/common/gason.{h,cpp}; dead code there), re-designed for this
framework's hot path: annotation files are scanned once in C++ and only the
columns the data stages need come back — numpy int64 arrays for ids/dims and
offset-sliced UTF-8 buffers for strings. No per-annotation Python dicts are
built, which is what makes the vocab/split-style scans several times faster
and ~10x smaller than ``json.load`` on the 80-500 MB COCO files.

``load_columns(path)`` returns a CocoColumns or None (native lib unavailable
or the file isn't plain COCO-shaped JSON) — callers always have the stdlib
path as fallback. The port builds its own copy of jsonlib.cpp with g++ at
the first call (adaptive_tpu_torch/native/build.py), never at import.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

_lib = None
_lib_err: Optional[str] = None


def _load_lib():
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    try:
        from adaptive_tpu_torch.native.build import ensure_json_built

        lib = ctypes.CDLL(ensure_json_built())
        lib.coco_json_parse.restype = ctypes.c_void_p
        lib.coco_json_parse.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        lib.coco_json_seen.restype = ctypes.c_longlong
        lib.coco_json_seen.argtypes = [ctypes.c_void_p]
        lib.coco_json_count.restype = ctypes.c_longlong
        lib.coco_json_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.coco_json_i64.restype = ctypes.POINTER(ctypes.c_longlong)
        lib.coco_json_i64.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.coco_json_buf.restype = ctypes.c_void_p
        lib.coco_json_buf.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.coco_json_buf_len.restype = ctypes.c_longlong
        lib.coco_json_buf_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.coco_json_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    except Exception as e:  # no g++ / build failure: fall back silently
        _lib_err = f"{type(e).__name__}: {e}"
        _lib = None
    return _lib


@dataclass
class CocoColumns:
    """Columnar view of a COCO annotation file (array order preserved)."""

    img_ids: np.ndarray       # int64 [n_imgs]
    img_heights: np.ndarray   # int64 [n_imgs], -1 if absent
    img_widths: np.ndarray    # int64 [n_imgs], -1 if absent
    file_names: List[str]
    ann_ids: np.ndarray       # int64 [n_anns]
    ann_img_ids: np.ndarray   # int64 [n_anns]
    captions: List[str]       # '' for caption-less (detection) annotations
    cat_ids: np.ndarray       # int64 [n_cats]
    cat_names: List[str]


def _strings(raw: bytes, offsets: np.ndarray) -> List[str]:
    return [raw[offsets[i]:offsets[i + 1]].decode("utf-8") for i in range(len(offsets) - 1)]


def load_columns(path: str) -> Optional[CocoColumns]:
    lib = _load_lib()
    if lib is None:
        return None
    err = ctypes.create_string_buffer(256)
    h = lib.coco_json_parse(path.encode(), err, len(err))
    if not h:
        return None  # caller falls back to stdlib json (and its error message)
    try:
        if not (lib.coco_json_seen(h) & 0b011):
            # syntactically valid JSON but no images/annotations keys: this is
            # not a COCO file — fall back so the stdlib path can raise its
            # loud KeyError instead of us silently returning empty columns.
            return None
        def ints(field, n):
            ptr = lib.coco_json_i64(h, field)
            return np.ctypeslib.as_array(ptr, shape=(n,)).copy() if n else np.zeros(0, np.int64)

        def buf(which):
            n = lib.coco_json_buf_len(h, which)
            p = lib.coco_json_buf(h, which)
            return ctypes.string_at(p, n) if n else b""

        n_img = lib.coco_json_count(h, 0)
        n_ann = lib.coco_json_count(h, 1)
        n_cat = lib.coco_json_count(h, 2)
        try:
            return _columns(lib, h, ints, buf, n_img, n_ann, n_cat)
        except UnicodeDecodeError:
            # A lone LOW surrogate escape ("\udc00") passes the C++ parser
            # (only lone high surrogates are rejected there) and comes back
            # as invalid UTF-8. stdlib json accepts lone surrogates, so honor
            # the documented contract: fall back rather than raise.
            return None
    finally:
        lib.coco_json_free(h)


def _columns(lib, h, ints, buf, n_img, n_ann, n_cat) -> CocoColumns:
    return CocoColumns(
            img_ids=ints(0, n_img),
            img_heights=ints(1, n_img),
            img_widths=ints(2, n_img),
            file_names=_strings(buf(0), ints(3, n_img + 1)),
            ann_ids=ints(4, n_ann),
            ann_img_ids=ints(5, n_ann),
            captions=_strings(buf(1), ints(6, n_ann + 1)),
            cat_ids=ints(7, n_cat),
            cat_names=_strings(buf(2), ints(8, n_cat + 1)),
        )


def load_captions(path: str) -> Optional[List[str]]:
    """Caption strings in annotation-array order, or None (fallback needed)."""
    cols = load_columns(path)
    return cols.captions if cols is not None else None
