"""loop_span_ms.decode: device ms a batch launched under the greedy
decoder's decode.loop span (precompute_slots, the state, the 30 steps and
the stacking of their outputs), from the traced slice (lib/span_split.py)."""

from benchmark.lib.span_split import launched_ms


def read(ctx):
    return launched_ms(ctx, "decode.loop")
