"""bn_elementwise_ms.train: device ms a step in batch-norm, elementwise and
reduction kernels, from the traced slice (the frozen stage split)."""

from benchmark.lib.readings import stage_ms


def read(ctx):
    return stage_ms(ctx, "elementwise/reduce")
