"""Seeded uint8 images, made on the device in a few calls: a random
cells x cells grid of colours blown up to the image size, plus pixel noise
of +-24 (images of independent noise all look alike to a network; coarse
structure sets them apart). The recipe of chip_smoke.py's seeded_images,
drawn with a torch.Generator instead of numpy."""

from __future__ import annotations

import torch


def seeded_images(n: int, seed: int, size: int, device, cells: int = 4) -> torch.Tensor:
    """uint8 NHWC [n, size, size, 3] on device."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    grid = torch.randint(0, 256, (n, cells, cells, 3), generator=gen, device=device,
                         dtype=torch.int16)
    up = grid.repeat_interleave(size // cells, 1).repeat_interleave(size // cells, 2)
    up += torch.randint(-24, 25, up.shape, generator=gen, device=device, dtype=torch.int16)
    return up.clamp_(0, 255).to(torch.uint8)
