"""conv1x1_fprop_roofline: percent of kernel 9's roofline (the bf16
encoder's stride-1 1x1 convolutions with their epilogue): the sum of each
launch's bound over an encode at the cell's batch (lib/conv1x1.py), times
the encodes in the traced slice, over kernel 9's device seconds there. The
slice holds whole batches, so its launches are whole encodes'. Where the
program has no kernel 9 the slice holds none of its launches, and the
metric is left out."""

from benchmark.lib.conv1x1 import encode_bound_s
from benchmark.lib.trace import kernel_stats

KERNEL = "conv1x1_fprop_epilogue_kernel"


def read(ctx):
    if not ctx.events:
        return None
    total_s, n = kernel_stats(ctx.events, (KERNEL,))
    if not n or not total_s:
        return None
    bound_s, per_encode = encode_bound_s(ctx.config, ctx.traffic["batch"])
    return 100.0 * bound_s * (n / per_encode) / total_s
