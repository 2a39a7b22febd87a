"""Image preprocessing on the device (counterpart of
adaptive_tpu/ops/preprocess.py): uint8 NHWC -> ImageNet-normalized float
NHWC; at train time a random crop and horizontal flip first, at eval time a
resize.

The random draws are split from the crop: ``draw_crop_flip`` draws (tops,
lefts, flips) from an explicit ``torch.Generator``, ``crop_flip`` applies
them, so any draws (the JAX package's, in the tests) can be fed to it.

The JAX package resizes with ``jax.image.resize(..., "bilinear")``, which
antialiases on downscale; ``F.interpolate(mode="bilinear",
align_corners=False, antialias=True)`` computes the same filter.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(images: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8/float NHWC -> normalized float NHWC, math in fp32."""
    x = images.to(torch.float32)
    if images.dtype == torch.uint8:
        x = x / torch.full((), 255.0, device=x.device)  # a true division (eval_preprocess)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(dtype)


def draw_crop_flip(gen: torch.Generator, batch: int, height: int, width: int,
                   crop: int):
    """(tops [B], lefts [B], flips [B] bool) on gen's device: a uniform
    corner of a crop x crop window and a fair coin for each image."""
    dev = gen.device
    tops = torch.randint(0, height - crop + 1, (batch,), generator=gen, device=dev)
    lefts = torch.randint(0, width - crop + 1, (batch,), generator=gen, device=dev)
    flips = torch.rand((batch,), generator=gen, device=dev) < 0.5
    return tops, lefts, flips


def crop_flip(images: torch.Tensor, tops, lefts, flips, crop: int) -> torch.Tensor:
    """Image b's crop x crop window at (tops[b], lefts[b]), mirrored
    left-right where flips[b]; NHWC of any dtype, one gather."""
    dev = images.device
    tops, lefts, flips = (torch.as_tensor(a, device=dev) for a in (tops, lefts, flips))
    r = torch.arange(crop, device=dev)
    rows = tops[:, None] + r
    cols = lefts[:, None] + torch.where(flips[:, None], crop - 1 - r, r)
    b = torch.arange(images.shape[0], device=dev)[:, None, None]
    return images[b, rows[:, :, None], cols[:, None, :]]


def random_crop_flip(gen: torch.Generator, images: torch.Tensor, crop: int) -> torch.Tensor:
    """RandomCrop(crop) + RandomHorizontalFlip (train.py:30-31), per image."""
    B, H, W, _ = images.shape
    return crop_flip(images, *draw_crop_flip(gen, B, H, W, crop), crop)


def center_crop(images: torch.Tensor, crop: int) -> torch.Tensor:
    _, H, W, _ = images.shape
    top, left = (H - crop) // 2, (W - crop) // 2
    return images[:, top:top + crop, left:left + crop, :]


def train_preprocess(gen: torch.Generator, images_u8: torch.Tensor, crop: int,
                     dtype=torch.float32) -> torch.Tensor:
    """uint8 NHWC (resized 256) -> augmented normalized float NHWC (crop)."""
    return normalize(random_crop_flip(gen, images_u8, crop), dtype)


def _resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """Antialiased bilinear resize of NHWC to (size, size). PyTorch's CPU
    antialias kernel refuses bf16, so on the CPU a bf16 input is resized in
    fp32 and rounded back; on the card the resize runs in the input dtype."""
    work = x
    if x.device.type == "cpu" and x.dtype == torch.bfloat16:
        work = x.float()
    y = F.interpolate(
        work.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
        align_corners=False, antialias=True,
    )
    return y.permute(0, 2, 3, 1).to(x.dtype)


def eval_preprocess(images_u8: torch.Tensor, size: int, dtype=torch.float32) -> torch.Tensor:
    """uint8 NHWC (any square size) -> resized normalized float NHWC (size).

    In bf16 mode the scaling, resize and normalization run in bf16, as in the
    JAX package (its preprocess.py:85); fp32 mode keeps the exact path.
    """
    work = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
    # a true division on every device: CUDA multiplies by the reciprocal of
    # a Python scalar divisor, which moves the card's pixels by an ulp from
    # the CPU's (and an int8 requant tie with them)
    x = images_u8.to(work) / torch.full((), 255.0, dtype=work, device=images_u8.device)
    if images_u8.shape[1] != size:
        x = _resize(x, size)
    mean = torch.tensor(IMAGENET_MEAN, dtype=work, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=work, device=x.device)
    return ((x - mean) / std).to(dtype)
