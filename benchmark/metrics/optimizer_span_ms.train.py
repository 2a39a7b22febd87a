"""optimizer_span_ms.train: device ms a step launched under the train step's
train.optimizer span (the division, the LSTM clip, the dual Adam steps),
from the traced slice (lib/span_split.py)."""

from benchmark.lib.span_split import launched_ms


def read(ctx):
    return launched_ms(ctx, "train.optimizer")
