"""Inverted dropout for the training forward (config knob train_dropout_rate;
counterpart of adaptive_tpu/ops/dropout.py).

Every attention/affine site in the reference carries an nn.Dropout whose
rate is hardcoded to zero (baseline_attention.py:26,73,
adaptive_attention.py:21,70,103); the paper trained with 0.5. The default
0.0 is the reference's behaviour; a non-zero rate scales kept values by
1/keep at train time at the same sites.

Each call of the returned closure draws a fresh mask from the explicit
``torch.Generator``, as one nn.Dropout module resamples per call. The masks
are not the JAX package's bits: the two packages draw from different
generators by design.

``rows=(index, count)``: the mask is drawn at the global batch's shape,
``count`` times the tensor's rows, and this rank keeps block ``index``, so a
data-parallel step draws what one process draws for the whole batch.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

Drop = Optional[Callable[[torch.Tensor], torch.Tensor]]


def make_dropout(gen: Optional[torch.Generator], rate: float,
                 rows: Optional[Tuple[int, int]] = None) -> Drop:
    """None when inactive (rate 0 or no generator); callers treat None as
    the identity. rows: (index, count) of this rank's block of the global
    batch (module docstring)."""
    if gen is None or not rate:
        return None
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    keep = 1.0 - float(rate)

    index, count = rows or (0, 1)

    def drop(x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        u = torch.rand((n * count, *x.shape[1:]), generator=gen, device=gen.device)
        u = u[index * n:(index + 1) * n].to(x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x)).to(x.dtype)

    return drop


def maybe_drop(drop: Drop, x: torch.Tensor) -> torch.Tensor:
    return x if drop is None else drop(x)
