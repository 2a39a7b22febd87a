"""Host-side data loading: COCO caption datasets and prefetching batch
iterators (counterpart of adaptive_tpu/data/loader.py, single process).

Reference parity: code_src/data/data_loader.py:12-119 (train loader: one
sample per annotation, tokenized to <start>+ids+<end>) and
code_src/tools/utils.py:71-104 (eval loader: images + ids only). The torch
DataLoader with 8 worker processes is replaced by a thread pool and a
bounded prefetch queue (the host work is PIL JPEG decode, which releases
the GIL). Train captions are padded to a few bucket lengths instead of
sorted and packed, and a batch shares one bucket. Images leave here as uint8
NHWC; the train step crops, flips and normalises them on the model's device
(ops/preprocess.py). The batch plan is numpy, the same plan as the JAX
package's for the same seed. PIL is imported inside ``_load_image_uint8``
only, as in the JAX package.
"""

from __future__ import annotations

import collections
import json
import os
import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from adaptive_tpu_torch.data.coco_api import COCO
from adaptive_tpu_torch.data.vocab import END_ID, Vocabulary

# Caption length buckets (token count incl. <start>/<end>): train captions
# are max 52 / mean 10.47 tokens (reference statics:10-12).
DEFAULT_BUCKETS = (16, 24, 32, 56)


def _load_image_uint8(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _image_subdir(filename: str) -> str:
    # Reference routes on the filename (data_loader.py:39-42).
    return "val2014" if "val" in filename.lower() else "train2014"


class CocoCaptionDataset:
    """One sample per annotation: (uint8 image, caption ids, image id).

    Parity: data_loader.py:12-61."""

    def __init__(self, root: str, anno_path: str, vocab: Vocabulary):
        self.root = root
        self.coco = COCO(anno_path)
        self.ids: List[int] = list(self.coco.anns.keys())
        self.vocab = vocab

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, List[int], int]:
        ann = self.coco.anns[self.ids[index]]
        img_id = ann["image_id"]
        filename = self.coco.loadImgs(img_id)[0]["file_name"]
        path = os.path.join(self.root, _image_subdir(filename), filename)
        image = _load_image_uint8(path)
        caption = self.vocab.encode_caption(ann["caption"])
        return image, caption, img_id


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


def pad_to_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (a caption length); captions longer than the
    last bucket are truncated to it (keeps <end> as the final token)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class TrainBatches:
    """Shuffled, bucket-padded, prefetching train batch iterator.

    Each batch: dict(images uint8 [B,S,S,3] NHWC, captions int32 [B,L],
    lengths int32 [B], img_ids int64 [B]) with L one of `buckets`. A batch
    groups samples of one bucket (vs. the reference's sort-by-length
    collate, data_loader.py:84-98). `dataset` is a CocoCaptionDataset or
    any object with its ``ids``, ``coco.anns``, ``vocab`` and
    ``__getitem__``."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        seed: int = 0,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        num_workers: int = 8,
        prefetch: int = 4,
        drop_last: bool = True,
        epoch: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.buckets = tuple(buckets)
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _make_batch(self, idxs: List[int]) -> Dict[str, np.ndarray]:
        lens = self._caption_lengths()
        bucket = max(pad_to_bucket(lens[i], self.buckets) for i in idxs)
        samples = [self.dataset[i] for i in idxs]
        images = np.stack([s[0] for s in samples])
        captions = np.zeros((len(samples), bucket), dtype=np.int32)  # <pad>=0
        lengths = np.zeros((len(samples),), dtype=np.int32)
        for r, (_, cap, _) in enumerate(samples):
            if len(cap) > bucket:  # truncate, keeping <end> terminal
                cap = list(cap[: bucket - 1]) + [END_ID]
            captions[r, : len(cap)] = cap
            lengths[r] = len(cap)
        img_ids = np.array([s[2] for s in samples], dtype=np.int64)
        return {"images": images, "captions": captions, "lengths": lengths, "img_ids": img_ids}

    def _batch_indices(self) -> List[List[int]]:
        rng = np.random.default_rng(self.seed + self.epoch)
        order = rng.permutation(len(self.dataset))
        by_bucket: Dict[int, List[int]] = {b: [] for b in self.buckets}
        lengths = self._caption_lengths()
        for i in order:
            by_bucket[pad_to_bucket(lengths[i], self.buckets)].append(int(i))
        batches: List[List[int]] = []
        leftovers: List[int] = []
        for b in self.buckets:
            idxs = by_bucket[b]
            for s in range(0, len(idxs) - self.batch_size + 1, self.batch_size):
                batches.append(idxs[s : s + self.batch_size])
            leftovers.extend(idxs[len(idxs) - (len(idxs) % self.batch_size) :])
        for s in range(0, len(leftovers), self.batch_size):
            chunk = leftovers[s : s + self.batch_size]
            if len(chunk) == self.batch_size or not self.drop_last:
                batches.append(chunk)
        rng.shuffle(batches)
        return batches

    def _caption_lengths(self) -> np.ndarray:
        if not hasattr(self, "_cap_lens"):
            ds = self.dataset
            self._cap_lens = np.array(
                [len(ds.vocab.encode_caption(ds.coco.anns[a]["caption"])) for a in ds.ids],
                dtype=np.int32,
            )
        return self._cap_lens

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        yield from self.iter_from(0)

    def iter_from(self, start_batch: int) -> Iterator[Dict[str, np.ndarray]]:
        """Iterate this epoch's batch plan from batch index `start_batch`
        (mid-epoch resume: the plan is a pure function of seed+epoch, so
        skipping the first K index lists replays the uninterrupted run's
        remaining batches; no image of a skipped batch is decoded)."""
        batches = self._batch_indices()
        yield from _prefetched(
            self._make_batch, batches[start_batch:], self.num_workers, self.prefetch
        )
        self.epoch += 1


def device_prefetch(iterator: Iterator, device, size: int = 2) -> Iterator:
    """Overlap host->device copies with compute: keep `size` batches in
    flight. On a CUDA device each array goes through pinned host memory
    with a non_blocking copy; on the CPU it is wrapped as a tensor."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def put(batch):
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.pin_memory().to(device, non_blocking=True) if pin else t
        return out

    buf = collections.deque()
    for item in iterator:
        buf.append(put(item))
        if len(buf) > size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


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
