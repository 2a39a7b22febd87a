"""ssm_step_roofline: percent of kernel 8's roofline (the Mamba-2 decode
step, ops/cuda/csrc/ssm_step.cu): the bound of one launch at the cell's
batch (lib/hybrid.py::ssm_step_work, bytes-bound) over its device seconds a
launch in the traced slice."""

from benchmark.lib.hybrid import ssm_step_work
from benchmark.lib.readings import roofline


def read(ctx):
    work = ssm_step_work(ctx.config, ctx.traffic["batch"])
    return roofline(ctx, ("ssm_state_step_kernel",), work)
