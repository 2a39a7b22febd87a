"""backward_span_ms.train: device ms a step launched under the train step's
train.backward spans (the autograd engine's launches, from its own thread),
from the traced slice (lib/span_split.py)."""

from benchmark.lib.span_split import launched_ms


def read(ctx):
    return launched_ms(ctx, "train.backward")
