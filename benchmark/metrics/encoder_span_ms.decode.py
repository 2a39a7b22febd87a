"""encoder_span_ms.decode: device ms a batch launched under the greedy
decoder's decode.preprocess or decode.encode spans (the images' copy,
resize and normalisation, the BN-folded trunk and the heads), from the
traced slice (lib/span_split.py)."""

from benchmark.lib.span_split import launched_ms


def read(ctx):
    return launched_ms(ctx, "decode.preprocess", "decode.encode")
