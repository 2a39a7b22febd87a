"""Host-side eval data loading: images of a COCO caption split in
prefetched, fixed-size batches (counterpart of adaptive_tpu/data/loader.py,
its eval part).

Reference parity: code_src/tools/utils.py:71-104 (eval loader: images + ids
only). The torch DataLoader with 8 worker processes is replaced by a thread
pool and a bounded prefetch queue (the host work is PIL JPEG decode, which
releases the GIL). Images leave here as uint8 NHWC; the decoders resize and
normalise them on the model's device (ops/preprocess.py). PIL is imported
inside ``_load_image_uint8`` only, as in the JAX package. The train loader
comes with the port's training slice.
"""

from __future__ import annotations

import json
import os
import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Tuple

import numpy as np


def _load_image_uint8(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _image_subdir(filename: str) -> str:
    # Reference routes on the filename (data_loader.py:39-42).
    return "val2014" if "val" in filename.lower() else "train2014"


class EvalImageDataset:
    """One sample per image: (uint8 image, image id). Parity: utils.py:71-104."""

    def __init__(self, root: str, anno_path: str):
        self.root = root
        with open(anno_path) as f:
            self.imgs = json.load(f)["images"]

    def __len__(self) -> int:
        return len(self.imgs)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, int]:
        info = self.imgs[index]
        path = os.path.join(self.root, _image_subdir(info["file_name"]), info["file_name"])
        return _load_image_uint8(path), info["id"]


class EvalBatches:
    """Sequential eval batch iterator: dict(images uint8, img_ids).

    The last short batch is padded up to batch_size by repeating the final
    sample (every batch has one shape); `valid` marks real rows. Parity:
    utils.py:148-150 (batch 400, no shuffle, drop_last=False). `dataset` is
    any object with __len__ and __getitem__(i) -> (uint8 HWC image, id).
    """

    def __init__(self, dataset, batch_size: int, num_workers: int = 8, prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _make_batch(self, idxs: List[int]) -> Dict[str, np.ndarray]:
        n_real = len(idxs)
        idxs = idxs + [idxs[-1]] * (self.batch_size - n_real)
        samples = [self.dataset[i] for i in idxs]
        images = np.stack([s[0] for s in samples])
        img_ids = np.array([s[1] for s in samples], dtype=np.int64)
        valid = np.arange(self.batch_size) < n_real
        return {"images": images, "img_ids": img_ids, "valid": valid}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idxs = list(range(len(self.dataset)))
        batches = [idxs[s : s + self.batch_size] for s in range(0, len(idxs), self.batch_size)]
        yield from _prefetched(self._make_batch, batches, self.num_workers, self.prefetch)


def _prefetched(fn, work_items: List, num_workers: int, prefetch: int) -> Iterator:
    """Run fn over work_items with a thread pool, yielding in order with a
    bounded prefetch window (replaces torch DataLoader worker processes)."""
    if not work_items:
        return
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        pending = queue.Queue()
        n_submitted = 0
        for item in work_items[:prefetch]:
            pending.put(pool.submit(fn, item))
            n_submitted += 1
        while not pending.empty():
            fut = pending.get()
            if n_submitted < len(work_items):
                pending.put(pool.submit(fn, work_items[n_submitted]))
                n_submitted += 1
            yield fut.result()
