"""conv_gemm_ms.train: device ms a step in cuDNN's convolutions and in
cuBLAS's and CUTLASS's products, from the traced slice."""

from benchmark.lib.readings import stage_ms


def read(ctx):
    return stage_ms(ctx, "conv (cuDNN)", "gemm (cuBLAS/CUTLASS)")
