"""elementwise_ms.decode: device ms a batch in PyTorch's elementwise and
reduction kernels, from the traced slice (the frozen stage split)."""

from benchmark.lib.readings import stage_ms


def read(ctx):
    return stage_ms(ctx, "elementwise/reduce")
