"""forward_span_ms.train: device ms a step launched under the train step's
train.forward spans (preprocess, model.forward, the masked CE), from the
traced slice (lib/span_split.py)."""

from benchmark.lib.span_split import launched_ms


def read(ctx):
    return launched_ms(ctx, "train.forward")
