"""Offline image resize stage (counterpart of adaptive_tpu/data/resize.py).

Reference parity: code_src/tools/resize.py:6-44: every image in train2014/
and val2014/ resized to ``resized_image_size`` x ``resized_image_size``
(256 x 256) with antialiasing into ``resized/``. The per-step crop, flip and
normalise run on the device (ops/preprocess.py); this stage is host file IO
once. Pillow is imported inside the stage only, so the rest of the port
runs without it.
"""

from __future__ import annotations

import os
from typing import Tuple


def resize_image(image, size: Tuple[int, int]):
    """PIL antialias resize (resize.py:6-8); LANCZOS == the old ANTIALIAS."""
    from PIL import Image

    return image.resize(size, Image.LANCZOS)


def resize_folder_images(image_dir: str, output_dir: str, size: Tuple[int, int]):
    """Resize all images in a folder (resize.py:11-26)."""
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    images = os.listdir(image_dir)
    num_images = len(images)
    for i, name in enumerate(images):
        src = os.path.join(image_dir, name)
        try:
            with Image.open(src) as img:
                resize_image(img.convert("RGB"), size).save(
                    os.path.join(output_dir, name), img.format or "JPEG"
                )
        except (OSError, ValueError) as e:
            print(f"skipping {src}: {e}")
        if (i + 1) % 100 == 0:
            print("[{}/{}] Resized the images and saved into '{}'.".format(
                i + 1, num_images, output_dir))


def main_resize_images(cf):
    """Resize train2014 + val2014 into resized/ (resize.py:29-44)."""
    size = (cf.resized_image_size, cf.resized_image_size)
    for split in ("train2014", "val2014"):
        src = os.path.join(cf.image_dir, split)
        dst = os.path.join(cf.resized_image_dir, split)
        if os.path.isdir(src):
            resize_folder_images(src, dst, size)
        else:
            print(f"resize: source dir missing, skipping: {src}")
