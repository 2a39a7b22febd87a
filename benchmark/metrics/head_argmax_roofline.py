"""head_argmax_roofline: percent of kernel 2's roofline (the greedy head's
product, bias and argmax): the bound of one launch at the cell's batch over
its device seconds a launch in the traced slice."""

from benchmark.lib import flops
from benchmark.lib.program import reference_config
from benchmark.lib.readings import roofline


def read(ctx):
    work = flops.head_argmax(reference_config(ctx.config), ctx.traffic["batch"])
    return roofline(ctx, ("head_argmax_",), work)
