"""Python bindings for the C++ RLE mask library (ctypes, numpy-facing;
counterpart of adaptive_tpu/native/mask.py).

Reference parity: the pycocotools mask API —
coco/PythonAPI/pycocotools/mask.py:77-104 wrapping _mask.pyx (Cython) over
maskApi.c. Same surface: encode / decode / merge / area / iou / toBbox /
frPyObjects, with RLE dicts {'size': [h, w], 'counts': bytes} and
column-major (Fortran) uint8 masks.
"""

from __future__ import annotations

import ctypes as C
import threading
from typing import Dict, List, Sequence, Union

import numpy as np

from adaptive_tpu_torch.native.build import ensure_built

_L = None
_lock = threading.Lock()


def _lib():
    """The mask library, built and loaded on the first call (never at import)."""
    global _L
    if _L is not None:
        return _L
    with _lock:
        if _L is not None:
            return _L
        lib = C.CDLL(ensure_built())
        lib.rleEncode.restype = C.c_void_p
        lib.rleEncode.argtypes = [C.POINTER(C.c_uint8), C.c_uint64, C.c_uint64]
        lib.rleDecode.argtypes = [C.c_void_p, C.POINTER(C.c_uint8)]
        lib.rleDecodeBounded.argtypes = [C.c_void_p, C.POINTER(C.c_uint8), C.c_uint64]
        lib.rleArea.restype = C.c_uint64
        lib.rleArea.argtypes = [C.c_void_p]
        lib.rleMerge.restype = C.c_void_p
        lib.rleMerge.argtypes = [C.POINTER(C.c_void_p), C.c_uint64, C.c_int]
        lib.rleToBbox.argtypes = [C.c_void_p, C.POINTER(C.c_double)]
        lib.rleIou.argtypes = [C.POINTER(C.c_void_p), C.c_uint64, C.POINTER(C.c_void_p),
                                C.c_uint64, C.POINTER(C.c_uint8), C.POINTER(C.c_double)]
        lib.bbIou.argtypes = [C.POINTER(C.c_double), C.c_uint64, C.POINTER(C.c_double),
                               C.c_uint64, C.POINTER(C.c_uint8), C.POINTER(C.c_double)]
        lib.rleNms.argtypes = [C.POINTER(C.c_void_p), C.c_uint64, C.POINTER(C.c_uint8), C.c_double]
        lib.rleFrBbox.restype = C.c_void_p
        lib.rleFrBbox.argtypes = [C.POINTER(C.c_double), C.c_uint64, C.c_uint64]
        lib.rleFrPoly.restype = C.c_void_p
        lib.rleFrPoly.argtypes = [C.POINTER(C.c_double), C.c_uint64, C.c_uint64, C.c_uint64]
        lib.rleToString.restype = C.c_uint64
        lib.rleToString.argtypes = [C.c_void_p, C.c_char_p]
        lib.rleFrString.restype = C.c_void_p
        lib.rleFrString.argtypes = [C.c_char_p, C.c_uint64, C.c_uint64]
        lib.rleFree.argtypes = [C.c_void_p]
        lib.rleRuns.restype = C.c_uint64
        lib.rleRuns.argtypes = [C.c_void_p]
        lib.rleH.restype = C.c_uint64
        lib.rleH.argtypes = [C.c_void_p]
        lib.rleW.restype = C.c_uint64
        lib.rleW.argtypes = [C.c_void_p]
        _L = lib
        return _L


RLEDict = Dict[str, Union[List[int], bytes]]


def _to_handle(rle: RLEDict) -> C.c_void_p:
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = counts.encode()
    return C.c_void_p(_lib().rleFrString(counts, h, w))


def _from_handle(handle, free: bool = True) -> RLEDict:
    h, w = _lib().rleH(handle), _lib().rleW(handle)
    m = _lib().rleRuns(handle)
    buf = C.create_string_buffer(int(8 * m + 16))  # <=7 chars per 32-bit count
    _lib().rleToString(handle, buf)
    out = {"size": [int(h), int(w)], "counts": buf.value}
    if free:
        _lib().rleFree(handle)
    return out


def encode(mask: np.ndarray) -> Union[RLEDict, List[RLEDict]]:
    """F-order uint8 mask [h,w] or [h,w,n] -> RLE dict(s) (mask.py:77-84)."""
    single = mask.ndim == 2
    if single:
        mask = mask[:, :, None]
    h, w, n = mask.shape
    out = []
    for i in range(n):
        m = np.asfortranarray(mask[:, :, i], dtype=np.uint8)
        flat = m.ravel(order="F").copy()
        handle = C.c_void_p(
            _lib().rleEncode(flat.ctypes.data_as(C.POINTER(C.c_uint8)), h, w)
        )
        out.append(_from_handle(handle))
    return out[0] if single else out


def decode(rles: Union[RLEDict, List[RLEDict]]) -> np.ndarray:
    """RLE dict(s) -> F-order uint8 mask [h,w] or [h,w,n] (mask.py:85-92)."""
    single = isinstance(rles, dict)
    rl = [rles] if single else list(rles)
    h, w = rl[0]["size"]
    out = np.zeros((h, w, len(rl)), np.uint8, order="F")
    for i, r in enumerate(rl):
        handle = _to_handle(r)
        buf = np.zeros(h * w, np.uint8)
        # bound by THIS buffer (sized from rl[0]): later RLEs in the list may
        # claim a different size, corrupt or otherwise
        _lib().rleDecodeBounded(handle, buf.ctypes.data_as(C.POINTER(C.c_uint8)), h * w)
        _lib().rleFree(handle)
        out[:, :, i] = buf.reshape(w, h).T  # column-major layout
    return out[:, :, 0] if single else out


def area(rles: Union[RLEDict, List[RLEDict]]):
    single = isinstance(rles, dict)
    rl = [rles] if single else list(rles)
    out = []
    for r in rl:
        handle = _to_handle(r)
        out.append(int(_lib().rleArea(handle)))
        _lib().rleFree(handle)
    return out[0] if single else np.array(out, np.uint64)


def merge(rles: List[RLEDict], intersect: bool = False) -> RLEDict:
    handles = [_to_handle(r) for r in rles]
    arr = (C.c_void_p * len(handles))(*[h.value for h in handles])
    merged = C.c_void_p(_lib().rleMerge(arr, len(handles), int(intersect)))
    for h in handles:
        _lib().rleFree(h)
    return _from_handle(merged)


def toBbox(rles: Union[RLEDict, List[RLEDict]]) -> np.ndarray:
    single = isinstance(rles, dict)
    rl = [rles] if single else list(rles)
    out = np.zeros((len(rl), 4))
    for i, r in enumerate(rl):
        handle = _to_handle(r)
        bb = (C.c_double * 4)()
        _lib().rleToBbox(handle, bb)
        _lib().rleFree(handle)
        out[i] = list(bb)
    return out[0] if single else out


def iou(dt, gt, iscrowd: Sequence[int]) -> np.ndarray:
    """IoU matrix: dt/gt are lists of RLE dicts OR [N,4] bbox arrays
    (mask.py:93-102 semantics incl. iscrowd union override). Where either
    side is empty the matrix is empty, [len(dt), len(gt)], as pycocotools
    returns no IoUs (_mask.pyx iou); the JAX package's copy sends an empty
    dt with boxes down the RLE path and raises TypeError there."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    crowd = np.asarray(iscrowd, np.uint8)
    if isinstance(dt, np.ndarray) or (len(dt) and isinstance(dt[0], (list, np.ndarray))):
        dtA = np.ascontiguousarray(np.asarray(dt, np.float64).reshape(len(dt), 4))
        gtA = np.ascontiguousarray(np.asarray(gt, np.float64).reshape(len(gt), 4))
        out = np.zeros((len(dt), len(gt)))
        _lib().bbIou(
            dtA.ctypes.data_as(C.POINTER(C.c_double)), len(dt),
            gtA.ctypes.data_as(C.POINTER(C.c_double)), len(gt),
            crowd.ctypes.data_as(C.POINTER(C.c_uint8)) if len(gt) else None,
            out.ctypes.data_as(C.POINTER(C.c_double)),
        )
        return out
    handles_d = [_to_handle(r) for r in dt]
    handles_g = [_to_handle(r) for r in gt]
    arr_d = (C.c_void_p * len(handles_d))(*[h.value for h in handles_d])
    arr_g = (C.c_void_p * len(handles_g))(*[h.value for h in handles_g])
    out = np.zeros((len(dt), len(gt)))
    _lib().rleIou(
        arr_d, len(dt), arr_g, len(gt),
        crowd.ctypes.data_as(C.POINTER(C.c_uint8)) if len(gt) else None,
        out.ctypes.data_as(C.POINTER(C.c_double)),
    )
    for h in handles_d + handles_g:
        _lib().rleFree(h)
    return out


def frPyObjects(pyobj, h: int, w: int):
    """Polygons / bboxes / RLE dicts -> RLE(s) (mask.py:103-104 semantics)."""
    if isinstance(pyobj, dict):
        return pyobj  # already RLE
    if isinstance(pyobj, (list, np.ndarray)) and len(pyobj) and not isinstance(pyobj[0], dict):
        first = pyobj[0]
        if isinstance(first, (list, np.ndarray)):  # list of polygons or boxes
            out = []
            for o in pyobj:
                o = np.asarray(o, np.float64)
                if o.size == 4:  # bbox
                    handle = C.c_void_p(
                        _lib().rleFrBbox(o.ctypes.data_as(C.POINTER(C.c_double)), h, w)
                    )
                else:  # polygon
                    handle = C.c_void_p(
                        _lib().rleFrPoly(
                            np.ascontiguousarray(o).ctypes.data_as(C.POINTER(C.c_double)),
                            o.size // 2, h, w,
                        )
                    )
                out.append(_from_handle(handle))
            return out
        # single flat polygon
        o = np.asarray(pyobj, np.float64)
        handle = C.c_void_p(
            _lib().rleFrPoly(np.ascontiguousarray(o).ctypes.data_as(C.POINTER(C.c_double)),
                           o.size // 2, h, w)
        )
        return _from_handle(handle)
    if isinstance(pyobj, list) and len(pyobj) and isinstance(pyobj[0], dict):
        return list(pyobj)
    raise TypeError("input type is not supported")
