"""Synthetic COCO-format fixtures for tests and benchmarks.

The reference's sanity fixture is a 20-image ``train_overfit`` split with one
annotation per image (reference code_src/data/KarpathySplit.py:38,64-67;
statics:6). This module fabricates a tiny COCO-caption dataset of the same
shape — deterministic images + captions — so the full pipeline (vocab, loader,
train, decode, scoring) runs hermetically with no MS-COCO download.

The PyTorch port's own copy of adaptive_tpu/data/synthetic.py: the same
code, so the port builds the same splits without importing the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

_OBJECTS = ["dog", "cat", "man", "woman", "horse", "bird", "car", "boat"]
_VERBS = ["riding", "holding", "watching", "chasing", "eating", "near"]
_PLACES = ["beach", "park", "street", "field", "kitchen", "mountain"]


def synthetic_caption(rng: np.random.Generator) -> str:
    a, b = rng.choice(_OBJECTS, size=2, replace=False)
    return "a {} {} a {} on the {}".format(a, rng.choice(_VERBS), b, rng.choice(_PLACES))


def make_synthetic_dataset(
    root: str,
    num_images: int = 20,
    captions_per_image: int = 1,
    image_size: int = 256,
    seed: int = 0,
    write_images: bool = True,
) -> Tuple[str, str]:
    """Create resized/{train2014,val2014} images + a COCO-format annotation json.

    Returns (annotation_path, resized_image_dir).
    """
    rng = np.random.default_rng(seed)
    resized_dir = os.path.join(root, "resized")
    img_dir = os.path.join(resized_dir, "train2014")
    os.makedirs(img_dir, exist_ok=True)

    images: List[dict] = []
    annotations: List[dict] = []
    ann_id = 1
    for i in range(num_images):
        fname = "COCO_train2014_%012d.jpg" % (i + 1)
        if write_images:
            arr = synthetic_image(i, image_size)
            from PIL import Image

            Image.fromarray(arr).save(os.path.join(img_dir, fname), "JPEG")
        images.append({"id": i + 1, "file_name": fname, "height": image_size, "width": image_size})
        for _ in range(captions_per_image):
            annotations.append(
                {"id": ann_id, "image_id": i + 1, "caption": synthetic_caption(rng)}
            )
            ann_id += 1

    data = {"type": "caption", "info": {}, "licenses": [], "images": images, "annotations": annotations}
    ann_path = os.path.join(root, "synthetic_captions.json")
    with open(ann_path, "w") as f:
        json.dump(data, f)
    return ann_path, resized_dir


def synthetic_image(index: int, size: int = 256) -> np.ndarray:
    """Deterministic uint8 RGB test pattern unique per index."""
    y = np.arange(size, dtype=np.float32)[:, None]
    x = np.arange(size, dtype=np.float32)[None, :]
    r = (np.sin(0.03 * (index + 1) * x) * 127 + 128).astype(np.uint8)
    g = (np.cos(0.05 * (index + 2) * y) * 127 + 128).astype(np.uint8)
    b = (((x + y) * (index + 3)) % 256).astype(np.uint8)
    return np.stack([np.broadcast_to(r, (size, size)), np.broadcast_to(g, (size, size)), b], axis=-1)
