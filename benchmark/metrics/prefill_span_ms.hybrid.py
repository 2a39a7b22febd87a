"""prefill_span_ms.hybrid: device ms a batch launched under the hybrid LM
decoder's decode.prefill span (the projector, the cache's allocation and
the prefill of the image tokens), from the traced slice (lib/
span_split.py)."""

from benchmark.lib.span_split import launched_ms


def read(ctx):
    return launched_ms(ctx, "decode.prefill")
