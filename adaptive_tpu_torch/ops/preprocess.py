"""Eval-time image preprocessing on the device: uint8 NHWC -> resized,
ImageNet-normalized float NHWC (counterpart of adaptive_tpu/ops/preprocess.py).

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
        x = x / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(dtype)


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
