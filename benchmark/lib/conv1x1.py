"""The work of kernel 9 (the bf16 encoder's stride-1 1x1 convolutions with
their epilogue, ops/cuda/csrc/conv1x1_epilogue.cu) in one encode, from the
trunk's shapes: each launch's GEMM and the bytes its roofline counts."""

from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark.lib import flops
from benchmark.reference.model import BOTTLENECK_STAGES

BF16 = 2  # bytes an element: the kernel runs in bf16 only


def launches(arch: str, crop: int, images: int) -> List[Tuple[int, int, int, bool]]:
    """[(M, K, N, residual)] of each launch of one encode of `images`
    images at crop px, in forward order: every bottleneck's conv1 (stride 1
    at the block input's resolution, bias + relu) and conv3 (at the block
    output's, with a residual: the block input or the downsample's output)."""
    out, h, cin = [], crop // 4, 64  # the 7x7/2 stem and the 3x3/2 max-pool
    for li, n in enumerate(BOTTLENECK_STAGES[arch]):
        width = 64 * 2 ** li
        for bi in range(n):
            out.append((images * h * h, cin, width, False))
            h //= 2 if (li > 0 and bi == 0) else 1
            out.append((images * h * h, width, 4 * width, True))
            cin = 4 * width
    return out


def work(m: int, k: int, n: int, residual: bool) -> Tuple[float, float]:
    """(bytes, FLOPs) of one launch: x [m, k], W [n, k], the residual [m, n]
    and y [m, n], each once; the product's 2mkn."""
    return float(BF16 * (m * k + n * k + m * n * (2 if residual else 1))), 2.0 * m * k * n


def encode_bound_s(config: Dict, images: int) -> Tuple[float, int]:
    """(the sum of each launch's bound in seconds, launches) of one encode."""
    shapes = launches(config["encoder_backbone"], config["train_crop_size"], images)
    return sum(flops.bound_s(*work(*s)) for s in shapes), len(shapes)
