"""cell_w1_roofline: percent of kernel 1's roofline (the bf16 adaptive
cell at W = 1, its two CUDA kernels a launch): the bound of one launch at
the cell's batch over its device seconds a launch in the traced slice."""

from benchmark.lib import flops
from benchmark.lib.program import reference_config
from benchmark.lib.readings import roofline


def read(ctx):
    work = flops.cell_w1(reference_config(ctx.config), ctx.traffic["batch"])
    return roofline(ctx, ("cell_gates_kernel", "cell_attend_kernel"), work)
