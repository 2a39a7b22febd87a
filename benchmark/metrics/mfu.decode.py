"""Percent of the card's bf16 peak (989 TFLOP/s): the model's FLOPs of the
window's batches or steps, from their shapes (lib/flops.py), over the
window's seconds on the host clock (the traced slice inside it)."""

from benchmark.lib.readings import peak_share


def read(ctx):
    return peak_share(ctx)
