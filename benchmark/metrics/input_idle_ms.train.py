"""input_idle_ms.train: device-idle ms a step (the gaps between the device's
busy intervals) while the main thread's innermost span is loader.wait or
prefetch.put, from the traced slice (lib/span_split.py)."""

from benchmark.lib.span_split import idle_ms


def read(ctx):
    return idle_ms(ctx, "loader.wait", "prefetch.put")
