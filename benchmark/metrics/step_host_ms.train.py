"""step_host_ms.train: host ms a step inside the train.step span, the time
the host takes to enqueue a step; against the device-busy ms a step it
says how launch-bound the step is (lib/span_split.py)."""

from benchmark.lib.span_split import host_ms


def read(ctx):
    return host_ms(ctx, "train.step")
